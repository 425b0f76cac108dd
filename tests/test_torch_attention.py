"""Port attention ops (synthanatomy_tpu_torch/ops/{local_attention,favor,
favor_attention,local_attention_flash}.py) against the JAX package.

Each plain version is held against JAX's XLA function and against the
Pallas kernel in interpret mode, forward and gradients (``jax.grad``
against torch autograd), on the same numpy-seeded inputs.  The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).

Tolerances: at f32 the two frameworks compute the same products and
sums in other orders, so outputs agree to ~1e-6 relative; the stated
bound is 1e-5 (rtol and atol, on values of order 1-50).  bf16 cases
agree to a few bf16 ulps (2^-8 relative) where both round at the same
points, looser where the paths round at different points (stated per
test).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.ops import favor as jfavor
from synthanatomy_tpu.ops import local_attention as jlocal
from synthanatomy_tpu.ops.favor_pallas import favor_attention_fused as jfused
from synthanatomy_tpu.ops.local_attention_pallas import local_attention_flash as jflash
from synthanatomy_tpu_torch.ops import favor as tfavor
from synthanatomy_tpu_torch.ops import favor_attention as tfa
from synthanatomy_tpu_torch.ops import local_attention as tlocal
from synthanatomy_tpu_torch.ops import local_attention_flash as tlf

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * scale).astype(np.float32) for _ in range(3)]


def _proj(seed, m, d):
    return np.asarray(jfavor.gaussian_orthogonal_random_matrix(jax.random.key(seed), m, d))


def _torch_grads(fn, q, k, v, dtype=torch.float32):
    """Forward of fn on torch copies and d(Σ out²)/d(q, k, v)."""
    ts = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _jax_grads(fn, q, k, v, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]

    def loss(*a):
        out = fn(*a).astype(jnp.float32)
        return jnp.sum(out ** 2), out

    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _close(got, want, **tol):
    out_t, grads_t = got
    out_j, grads_j = want
    np.testing.assert_allclose(out_t, out_j, **tol, err_msg="forward")
    for name, a, b in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(a, b, **tol, err_msg=f"d{name}")


def test_rotary_matches_jax():
    pos = np.arange(37)
    sin_j, cos_j = jlocal.rotary_sin_cos(16, jnp.asarray(pos))
    sin_t, cos_t = tlocal.rotary_sin_cos(16, torch.tensor(pos))
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **F32_TOL)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **F32_TOL)
    x = _qkv(0, (2, 37, 16))[0]
    np.testing.assert_allclose(
        tlocal.apply_rotary(torch.tensor(x), sin_t, cos_t).numpy(),
        np.asarray(jlocal.apply_rotary(jnp.asarray(x), sin_j, cos_j)), **F32_TOL)


@pytest.mark.parametrize("n,window,causal", [(16, 4, True), (21, 6, True), (5, 8, True),
                                             (20, 6, False)])
def test_local_attention_matches_xla(n, window, causal):
    q, k, v = _qkv(1, (2, 2, n, 8))
    got = _torch_grads(lambda a, b, c: tlocal.local_attention(
        a, b, c, window=window, causal=causal), q, k, v)
    want = _jax_grads(lambda a, b, c: jlocal.local_attention(
        a, b, c, window=window, causal=causal), q, k, v)
    _close(got, want, **F32_TOL)


@pytest.mark.parametrize("n,window", [(16, 4), (21, 6), (5, 8), (40, 7)])
def test_local_flash_plain_matches_pallas_and_xla(n, window):
    """The kernel's plain twin against the Pallas kernel (interpret) and
    the XLA path, f32: L not a multiple of the block, L < w, w not a
    multiple of anything."""
    q, k, v = _qkv(2, (1, 2, n, 8))
    got = _torch_grads(lambda a, b, c: tlf.local_attention_flash(
        a, b, c, window=window, compute_dtype=torch.float32), q, k, v)
    pallas = _jax_grads(lambda a, b, c: jflash(
        a, b, c, window=window, interpret=True, compute_dtype=jnp.float32), q, k, v)
    xla = _jax_grads(lambda a, b, c: jlocal.local_attention(a, b, c, window=window), q, k, v)
    _close(got, pallas, **F32_TOL)
    _close(got, xla, **F32_TOL)


def test_local_flash_plain_bf16_matches_pallas():
    """bf16 operands: forward and dq round at the same points as the
    Pallas kernel (a few bf16 ulps, 2e-2 relative of values ~1); dk/dv
    round once here and once per look-back block there, hence 3e-2."""
    q, k, v = _qkv(3, (1, 2, 40, 16))
    got = _torch_grads(lambda a, b, c: tlf.local_attention_flash(
        a, b, c, window=12, compute_dtype=torch.bfloat16), q, k, v, torch.bfloat16)
    want = _jax_grads(lambda a, b, c: jflash(
        a, b, c, window=12, interpret=True, compute_dtype=jnp.bfloat16, block_size=32),
        q, k, v, jnp.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("is_query", [True, False])
def test_softmax_kernel_features_match_jax(is_query):
    x = _qkv(4, (2, 2, 19, 8))[0]
    p = _proj(5, 16, 8)
    stab = None if is_query else 0.0
    want = jfavor.softmax_kernel_features(
        jnp.asarray(x), jnp.asarray(p), is_query=is_query,
        stabilizer=None if stab is None else jnp.zeros(()))
    got = tfavor.softmax_kernel_features(
        torch.tensor(x), torch.tensor(p), is_query=is_query,
        stabilizer=None if stab is None else torch.zeros(()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("mode", ["softmax", "stabilize_keys", "generalized",
                                  "no_projection", "noncausal"])
def test_favor_attention_matches_xla(mode):
    q, k, v = _qkv(6, (2, 2, 21, 8))
    p = _proj(7, 16, 8)
    kw = dict(causal=mode != "noncausal", generalized=mode == "generalized",
              stabilize_keys=mode == "stabilize_keys", chunk=8)
    pj = None if mode == "no_projection" else jnp.asarray(p)
    pt = None if mode == "no_projection" else torch.tensor(p)
    got = _torch_grads(lambda a, b, c: tfavor.favor_attention(a, b, c, pt, **kw), q, k, v)
    want = _jax_grads(lambda a, b, c: jfavor.favor_attention(a, b, c, pj, **kw), q, k, v)
    _close(got, want, rtol=1e-4, atol=1e-4)


def test_favor_bf16_compute_matches_xla():
    """bf16 operands in the chunk products, both frameworks rounding at
    the same points: a few bf16 ulps of outputs of order 1."""
    q, k, v = _qkv(8, (2, 2, 37, 16))
    p = _proj(9, 32, 16)
    kw = dict(causal=True, chunk=8)
    got = tfavor.favor_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 torch.tensor(p), compute_dtype=torch.bfloat16, **kw)
    want = jfavor.favor_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(p), compute_dtype=jnp.bfloat16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n,chunk", [(37, 16), (21, 8), (16, 16)])
def test_favor_fused_plain_matches_pallas_and_xla(n, chunk):
    """The fused kernel's plain twin against the Pallas kernel
    (interpret) and the XLA path: forward and the two-sweep backward,
    f32, with L a multiple of the chunk or not."""
    q, k, v = _qkv(10, (1, 2, n, 8))
    p = _proj(11, 16, 8)
    pt, pj = torch.tensor(p), jnp.asarray(p)
    got = _torch_grads(lambda a, b, c: tfa.favor_attention_fused(a, b, c, pt, chunk), q, k, v)
    pallas = _jax_grads(lambda a, b, c: jfused(a, b, c, pj, chunk, True), q, k, v)
    xla = _jax_grads(lambda a, b, c: jfavor.favor_attention(a, b, c, pj, chunk=8), q, k, v)
    _close(got, pallas, rtol=1e-4, atol=1e-4)
    _close(got, xla, rtol=1e-4, atol=1e-4)


def test_favor_fused_plain_row_max_ties():
    """Two identical projection rows make the query stabilizer's row max
    a tie in every row; its cotangent must split evenly over the tied
    features, as JAX's reduce_max VJP and the Pallas kernel split it."""
    rng = np.random.default_rng(12)
    d, m = 8, 16
    p = _proj(13, m, d).copy()
    p[0] = p[1] = 3.0 * p[0] / np.linalg.norm(p[0])
    base = p[0] / np.linalg.norm(p[0])
    q = (base[None, None, None, :] * rng.uniform(1.0, 2.0, size=(1, 2, 11, 1))
         + 0.05 * rng.normal(size=(1, 2, 11, d))).astype(np.float32)
    k, v = _qkv(14, (1, 2, 11, d))[:2]
    u = (q * d ** -0.25) @ p.T
    assert (u[..., 0] == u[..., 1]).all() and (u.argmax(-1) <= 1).all()
    pt, pj = torch.tensor(p), jnp.asarray(p)
    got = _torch_grads(lambda a, b, c: tfa.favor_attention_fused(a, b, c, pt, 8), q, k, v)
    pallas = _jax_grads(lambda a, b, c: jfused(a, b, c, pj, 8, True), q, k, v)
    xla = _jax_grads(lambda a, b, c: jfavor.favor_attention(a, b, c, pj, chunk=8), q, k, v)
    _close(got, pallas, rtol=1e-4, atol=1e-4)
    _close(got, xla, rtol=1e-4, atol=1e-4)


def test_favor_fused_plain_bf16_matches_pallas():
    """bf16 operands, both at the Pallas kernel's rounding points: a few
    bf16 ulps (3e-2 of values of order 1; gradients of order 10 at 5e-2
    relative)."""
    q, k, v = _qkv(15, (1, 2, 37, 16), scale=0.5)
    p = _proj(16, 32, 16)
    pt, pj = torch.tensor(p), jnp.asarray(p)
    got = _torch_grads(lambda a, b, c: tfa.favor_attention_fused(a, b, c, pt, 16),
                       q, k, v, torch.bfloat16)
    want = _jax_grads(lambda a, b, c: jfused(a, b, c, pj, 16, True), q, k, v, jnp.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=3e-2, atol=3e-2)
    for a, b in zip(got[1], want[1]):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=5e-2)


def test_favor_routing_follows_jax(monkeypatch):
    """use_pallas_scan reaches the fused kernel only for causal softmax
    features with a projection and the zero key stabilizer."""
    calls = []
    real = tfa.favor_attention_fused
    monkeypatch.setattr(tfa, "favor_attention_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.tensor(x) for x in _qkv(17, (1, 2, 9, 8)))
    p = torch.tensor(_proj(18, 16, 8))
    tfavor.favor_attention(q, k, v, p, use_pallas_scan=True)
    assert len(calls) == 1
    for kw in (dict(generalized=True), dict(causal=False), dict(stabilize_keys=True)):
        tfavor.favor_attention(q, k, v, p, use_pallas_scan=True, **kw)
    tfavor.favor_attention(q, k, v, None, use_pallas_scan=True)
    assert len(calls) == 1


def test_kernel_wrappers_refuse_other_devices():
    """Neither wrapper falls back to its plain version off the CPU."""
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        tfa.favor_attention_fused(q, q, q, torch.zeros(16, 8, device="meta"))
    with pytest.raises(ValueError):
        tlf.local_attention_flash_core(q, q, q, 4)
