"""The kernel-body probe (row 9d: ``ops/kernel_body.py`` and
``tools/probe_kernel_body.py`` of the port) against the JAX package, on
the CPU, where every wrapper takes its plain twin.  The CUDA variants
are held against the same twins on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.

The JAX tool itself is not imported (at import it points JAX's
compilation cache into the repo): its bodies are rebuilt from the
package.  Local attention: the production-equal twins (forward
``foldscale``, backward ``full``) against ``local_attention_pallas``'s
``_forward`` / ``_backward`` in interpret mode, and the forward bodies
that compute the same function another way (``full``, ``defer``,
``nomax``) against the same reference.  FAVOR+: each body's twin
against ``favor_pallas._fwd_impl`` / ``_bwd_impl`` in interpret mode
under the patches the JAX probe makes (``_features`` → identity
features, ``_tri`` → all true).  The ``matmuls`` twins against numpy.

Tolerances: f32 sums in other orders agree to ~1e-6 relative (bound
1e-5; FAVOR 1e-4 on gradients of order 10-100, as in
tests/test_torch_attention.py).  bf16: both round at the same points,
so a few bf16 ulps (2^-8 relative; bound 2e-2 of values of order 1);
the JAX backward rounds each query block's dk/dv share before folding
them, the port rounds once (bound 3e-2).  Identity-feature inputs are
positive (q, k and the projection), so the denominator stays positive:
where it crosses zero the 1e-12 clamp turns rounding into noise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.ops import favor_pallas as jfav
from synthanatomy_tpu.ops import local_attention_pallas as jlap
from synthanatomy_tpu_torch.ops import kernel_body as kb
from synthanatomy_tpu_torch.tools import probe_kernel_body

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SHAPE, W = (1, 2, 200, 16), 40  # L not a multiple of the JAX block (64) or the port's (32)
FSHAPE, M, CHUNK = (1, 2, 200, 16), 32, 16
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = [("float32", torch.float32, jnp.float32), ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _arrays(shape, seed, n=4, positive=False):
    rng = np.random.default_rng(seed)
    xs = [(rng.normal(size=shape) * 0.5).astype(np.float32) for _ in range(n)]
    if positive:
        xs[0], xs[1] = np.abs(xs[0]), np.abs(xs[1])
    return xs


def _t(xs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _j(xs, dtype):
    return [jnp.asarray(x, dtype) for x in xs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _jax_local(q, k, v, g, window):
    bias = jlap._bias_for(window, None)
    fwd = jax.jit(lambda *a: jlap._forward(*a, bias, window, None, True))
    bwd = jax.jit(lambda *a: jlap._backward(*a, bias, window, None, True))
    return fwd(q, k, v), bwd(q, k, v, g)


@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_local_twins_match_pallas(name, tdt, jdt):
    """foldscale and bwd full equal the Pallas kernels' functions;
    full, defer and nomax compute the same forward another way."""
    xs = _arrays(SHAPE, 1)
    q, k, v, g = _t(xs, tdt)
    out_j, grads_j = _jax_local(*_j(xs, jdt), W)
    tol = TOL[name]
    for body in ("foldscale", "full", "defer", "nomax"):
        np.testing.assert_allclose(_f32(kb.local_fwd_body_plain(q, k, v, W, body)), _f32(out_j),
                                   **tol, err_msg=body)
    bwd_tol = tol if name == "float32" else dict(rtol=3e-2, atol=3e-2)
    for out_f32 in (False, True):
        grads = kb.local_bwd_body_plain(q, k, v, g, W, "full", out_f32)
        assert all(x.dtype == (torch.float32 if out_f32 else tdt) for x in grads)
        for n, a, b in zip("qkv", grads, grads_j):
            np.testing.assert_allclose(_f32(a), _f32(b), **bwd_tol, err_msg=f"d{n}")


def test_local_matmuls_twins_match_numpy():
    """matmuls: S = q·kᵀ·d^-1/2 and dP = g·vᵀ, each zero outside the band
    (i − w < j ≤ i); out = S·v; dq = dP·k·d^-1/2, dk = dPᵀ·q·d^-1/2, dv =
    Sᵀ·g (f32: no rounding)."""
    q, k, v, g = _arrays(SHAPE, 2)
    n, d = SHAPE[2:]
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    band = (j <= i) & (j > i - W)
    s = np.where(band, q @ np.swapaxes(k, -1, -2) * d ** -0.5, 0.0)
    dp = np.where(band, g @ np.swapaxes(v, -1, -2), 0.0)
    want = [s @ v, dp @ k * d ** -0.5, np.swapaxes(dp, -1, -2) @ q * d ** -0.5,
            np.swapaxes(s, -1, -2) @ g]
    tq, tk, tv, tg = _t([q, k, v, g], torch.float32)
    got = [kb.local_fwd_body_plain(tq, tk, tv, W, "matmuls"),
           *kb.local_bwd_body_plain(tq, tk, tv, tg, W, "matmuls")]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def _id_features(q, k, p_ref, cd):
    """The JAX probe's identity features (tools/probe_kernel_body.py:268-273)."""
    p = p_ref[...]
    u_q = jfav._pdot(q.astype(cd), p.astype(cd))
    u_k = jfav._pdot(k.astype(cd), p.astype(cd))
    return u_q, u_k, u_q, u_k, u_q


def _favor_case(seed, body="full"):
    """Seeded inputs; for identity features positive q, k and projection
    (the denominator stays positive), else a Gaussian projection.  Without
    the causal select, the Pallas kernel's zero-padded rows past L would
    enter the last chunk's sums (their key features are not zero); the
    port has no such rows, so "nomask" takes L a multiple of the chunk."""
    pos = body == "idfeat"
    shape = FSHAPE[:2] + (FSHAPE[2] // CHUNK * CHUNK,) + FSHAPE[3:] if body == "nomask" \
        else FSHAPE
    xs = _arrays(shape, seed, positive=pos)
    rng = np.random.default_rng(seed + 1)
    proj = rng.uniform(0.0, 0.1, size=(M, shape[-1])) if pos else rng.normal(
        size=(M, shape[-1]))
    return xs, proj.astype(np.float32)


@pytest.mark.parametrize("body", kb.FAVOR_BODIES)
@pytest.mark.parametrize("name,tdt,jdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_favor_twins_match_patched_pallas(monkeypatch, body, name, tdt, jdt):
    """Each FAVOR body's twin against the Pallas kernels under the JAX
    probe's patches: forward (out, den), then both backward sweeps."""
    if body == "idfeat":
        monkeypatch.setattr(jfav, "_features", _id_features)
    if body == "nomask":
        monkeypatch.setattr(jfav, "_tri", lambda c: jnp.bool_(True))
    xs, proj = _favor_case(3, body)
    qj, kj, vj, gj = _j(xs, jdt)
    b, h, n, d = xs[0].shape
    nc = -(-n // CHUNK)
    # fresh functions under jit: a trace cached under one test's patches
    # must not serve another's
    out_j, den_j, _ = jax.jit(lambda *a: jfav._fwd_impl(*a, CHUNK, True))(
        qj, kj, vj, jnp.asarray(proj))
    grads_j = jax.jit(lambda *a: jfav._bwd_impl(*a, nc, CHUNK, True))(
        qj, kj, vj, jnp.asarray(proj), gj, out_j, den_j)
    q, k, v, g = _t(xs, tdt)
    p = torch.from_numpy(proj)
    out, den = kb.favor_fwd_body_plain(q, k, v, p, CHUNK, body)
    assert float(den.min()) > 0.0
    tol = dict(rtol=1e-4, atol=1e-4) if name == "float32" else TOL[name]
    np.testing.assert_allclose(_f32(out).reshape(b * h, n, d), _f32(out_j)[:, :n], **tol)
    np.testing.assert_allclose(_f32(den), _f32(den_j)[:, :n, 0], **tol)
    got = [kb.favor_bwd_body_plain(q, k, v, p, g, out, den, CHUNK, body, "dq"),
           *kb.favor_bwd_body_plain(q, k, v, p, g, out, den, CHUNK, body, "dkv")]
    for nm, a, bj in zip(("dq", "dk", "dv"), got, grads_j):
        a, bj = _f32(a), _f32(bj)
        scale = np.abs(bj).max()
        # identity features: dq = du·P·d^-1/4 − w·d^-1/2·q nearly cancels
        # (f32 sums in other orders: ~1e-4 of the largest dq)
        atol = 5e-4 if (body, nm, name) == ("idfeat", "dq", "float32") else tol["atol"]
        np.testing.assert_allclose(a / scale, bj / scale, rtol=0, atol=atol,
                                   err_msg=f"{body} {nm}")


def test_favor_full_twin_is_production_plain():
    """body "full" is the production plain version, bit for bit."""
    xs, proj = _favor_case(4)
    q, k, v, g = _t(xs, torch.bfloat16)
    p = torch.from_numpy(proj)
    out, den, dq, dk, dv = kb.favor_production(q, k, v, p, g, CHUNK)
    out_b, den_b = kb.favor_fwd_body(q, k, v, p, CHUNK, "full")
    assert torch.equal(out, out_b) and torch.equal(den, den_b)
    assert torch.equal(kb.favor_bwd_body(q, k, v, p, g, out, den, CHUNK, "full", "dq"), dq)
    dk_b, dv_b = kb.favor_bwd_body(q, k, v, p, g, out, den, CHUNK, "full", "dkv")
    assert torch.equal(dk, dk_b) and torch.equal(dv, dv_b)


def test_kernel_body_wrappers_reject_bad_inputs():
    meta = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        kb.local_fwd_body(meta, meta, meta, 4)
    with pytest.raises(ValueError):
        kb.favor_fwd_body(meta, meta, meta, torch.empty(8, 16, device="meta"))
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        kb.local_fwd_body(q, q, q, 4, body="nosuch")
    with pytest.raises(ValueError):
        kb.favor_bwd_body(q, q, q, torch.zeros(8, 16), q, q, torch.zeros(2, 8), sweep="dx")
    assert "does not fit: 300000 bytes" in str(kb.DoesNotFit("local_fwd_body", 300000))


def test_probe_cli_runs_on_cpu(monkeypatch, capsys):
    for name, value in (("B", 1), ("H", 2), ("L", 70), ("D", 16), ("W", 20), ("M_FEAT", 16),
                        ("CHUNK", 16), ("SMALL", (1, 3, 50, 16)), ("SMALL_W", 12),
                        ("SMALL_M", 8), ("SMALL_CHUNK", 16), ("SMALL_HPB", 2)):
        monkeypatch.setattr(probe_kernel_body, name, value)
    res = probe_kernel_body.main(["--cpu", "--reps", "1"])
    out = capsys.readouterr().out
    assert "equal to the production kernels bit for bit" in out
    labels = [r[0] for r in probe_kernel_body.LOCAL_FWD_ROWS]
    assert list(res["local_fwd"]) == labels and all(label in out for label in labels)
    assert len(res["local_bwd"]) == 6 and len(res["favor"]) == 6
    assert all(r["s"] > 0 for t in ("local_fwd", "local_bwd", "favor") for r in res[t].values())
    assert res["favor"]["dq full (fwd+dq measured; subtract fwd)"]["with_fwd_s"] > 0
    quick = probe_kernel_body.main(["--cpu", "--reps", "1", "--quick"])
    assert len(quick["local_bwd"]) == 3 and len(quick["favor"]) == 2


def test_mma_steps_exact_rounds_each_step_once():
    """The diagnostic's exactly rounded k16 steps (the CPU form of
    ``kb.mma_steps``) against float64 sums of the same bf16 products,
    rounded to f32 after each step."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(16, 48)).astype(np.float32)).to(torch.bfloat16)
    bt = torch.from_numpy(rng.normal(size=(8, 48)).astype(np.float32)).to(torch.bfloat16)
    c = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    got = kb.mma_steps(a, bt, c)
    acc = c.numpy().astype(np.float64)
    for s in range(3):
        sl = slice(16 * s, 16 * s + 16)
        acc = (acc + a.double().numpy()[:, sl] @ bt.double().numpy()[:, sl].T).astype(
            np.float32).astype(np.float64)
        np.testing.assert_array_equal(got[s].numpy(), acc.astype(np.float32))
    with pytest.raises(ValueError):
        kb.mma_steps(a[:, :40], bt[:, :40], c)


def test_dq_terms_rebuild_the_plain_dq():
    """The plain twin's dq sweep split at its last product
    (``favor_dq_terms``) gives the plain twin's dq, and the diagnostic,
    run on the CPU (where the kernel is the twin), finds no miss, no ds
    rounding flip and no excess over the bound."""
    res = probe_kernel_body.dq_cancellation(torch.device("cpu"), (1, 2, 40, 16))
    assert res["kernel"] == res["plain"] == res["dq_from_plain_sum"]
    assert res["ds_flips"] == [] and res["excess_over_bound_max"] == 0.0
    assert res["card_vs_exact_dqp_max"] < 1e-6
