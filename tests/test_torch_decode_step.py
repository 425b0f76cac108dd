"""The port's exact decode path (synthanatomy_tpu_torch: ``favor_attention_step``,
``local_attention_step``, ``Performer.init_cache`` / ``prime_cache`` /
``decode_step``, ``sample``, ``sample_naive`` and ``make_sampler(fused=False)``)
against the JAX package on the same weights and inputs.

Small prior, f32: 2 layers, d 32, 4 heads of 8 (2 local, window 8), m 16,
a (2, 3, 2) grid (12 tokens + BOS, so the 8-slot ring wraps).  Inputs are
made with numpy from seeds; weights come from the JAX init through
``performer_from_jax``.

Tolerances: the two packages run the same f32 operations and differ by
summation order (~1e-6 relative), so the step functions and the
incremental logits are held to 1e-5 and 1e-4; the incremental logits
against the batch forward take the 8e-2 of tests/test_performer.py and,
at f32, the 2e-5 of its tight test.  Greedy grids must be equal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.models import sampling as js
from synthanatomy_tpu.models.ordering import Ordering
from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu.ops import favor as jfavor
from synthanatomy_tpu.ops import local_attention as jlocal
from synthanatomy_tpu_torch.interop import performer_from_jax
from synthanatomy_tpu_torch.models import sampling as ts
from synthanatomy_tpu_torch.ops import favor as tfavor
from synthanatomy_tpu_torch.ops import local_attention as tlocal

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRID = (2, 3, 2)
L = 12
VOCAB = 17
DEPTH = 2
DIM = 32
CONDS = (3, 5)

# tests/test_performer.py's variant list, both spatial kinds and both
# conditioning types
VARIANTS = {
    "default": {},
    "rotary": dict(rotary_position_emb=True),
    "fixed": dict(fixed_position_emb=True),
    "axial": dict(axial_position_emb=True),
    "rezero": dict(use_rezero=True),
    "scalenorm": dict(use_scalenorm=True),
    "glu": dict(ff_glu=True),
    "tie-embed": dict(tie_embed=True),
    "generalized": dict(generalized_attention=True),
    "no-local": dict(local_attn_heads=0),
    "all-local": dict(local_attn_heads=4),
    "spatial-absolute": dict(spatial_position_emb="absolute"),
    "spatial-fixed": dict(spatial_position_emb="fixed"),
    "bos-replacement": dict(conditioning_num_tokens=CONDS, conditioning_type="bos_replacement"),
    "prepending": dict(conditioning_num_tokens=CONDS, conditioning_type="prepending"),
}


def _config(**extra):
    kw = dict(heads=4, dim_head=8, local_attn_heads=2, local_window_size=8, nb_features=16,
              scan_chunk=8)
    kw.update(extra)
    if kw.get("spatial_position_emb"):
        kw.update(spatial_shape=GRID, ordering=Ordering("raster_scan", 3, GRID))
    return kw


def _conds(kw):
    if not kw.get("conditioning_num_tokens"):
        return None
    return [np.asarray([0, 2], np.int32), np.asarray([1, 4], np.int32)]


def _models(**extra):
    kw = _config(**extra)
    jm = JPerformer(num_tokens=VOCAB, max_seq_len=L + 1, dim=DIM, depth=DEPTH,
                    dtype=jnp.float32, **kw)
    conds = _conds(kw)
    jconds = None if conds is None else [jnp.asarray(c) for c in conds]
    variables = jax.jit(jm.init)({"params": jax.random.key(0), "favor": jax.random.key(1)},
                                 jnp.zeros((2, L), jnp.int32), jconds)
    params = jax.device_get(variables["params"])
    if kw.get("use_rezero"):  # ReZero starts at identity: use real gains
        params = dict(params)
        for i in range(DEPTH):
            params[f"block_{i}"] = dict(params[f"block_{i}"], g_attn=np.asarray([0.7], np.float32),
                                        g_ff=np.asarray([0.5], np.float32))
    favor = jax.device_get(variables.get("favor", {}))
    variables = {"params": params, "favor": favor}
    tm = performer_from_jax(params, favor, DEPTH, device="cpu", dtype=torch.float32,
                            max_seq_len=L + 1, **kw)
    return jm, variables, tm, conds


@functools.lru_cache(maxsize=None)
def _named(name):
    """The models of one variant, built once per test process."""
    return _models(**VARIANTS[name])


def _tokens(seed):
    x = np.random.default_rng(seed).integers(0, VOCAB - 1, size=(2, L)).astype(np.int32)
    x[:, 0] = VOCAB - 1
    return x


def _jax_incremental(jm, variables, x, conds):
    jconds = None if conds is None else [jnp.asarray(c) for c in conds]
    step = jax.jit(lambda v, tok, cache, t: jm.apply(v, tok, cache, t, jconds,
                                                     method=jm.decode_step))
    cache = jm.apply(variables, x.shape[0], method=jm.init_cache)
    if jconds is not None and jm.conditioning_type == "prepending":
        cache = jm.apply(variables, cache, jconds, method=jm.prime_cache)
    out = []
    for t in range(x.shape[1]):
        logits, cache = step(variables, jnp.asarray(x[:, t]), cache, jnp.asarray(t, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def _port_incremental(tm, x, conds):
    tconds = None if conds is None else [torch.from_numpy(c) for c in conds]
    cache = tm.init_cache(x.shape[0])
    if tconds is not None and tm.conditioning_type == "prepending":
        cache = tm.prime_cache(cache, tconds)
    out = []
    with torch.no_grad():
        for t in range(x.shape[1]):
            logits, cache = tm.decode_step(torch.from_numpy(x[:, t]).long(), cache, t, tconds)
            out.append(logits.numpy())
    return np.stack(out, axis=1)


@pytest.fixture(scope="module", params=list(VARIANTS), ids=list(VARIANTS))
def variant(request):
    jm, variables, tm, conds = _named(request.param)
    x = _tokens(1)
    return request.param, jm, variables, tm, conds, x, _port_incremental(tm, x, conds)


def test_decode_step_matches_jax(variant):
    _, jm, variables, _, conds, x, got = variant
    want = _jax_incremental(jm, variables, x, conds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_incremental_matches_batch_forward(variant):
    name, _, _, tm, conds, x, got = variant
    tconds = None if conds is None else [torch.from_numpy(c) for c in conds]
    with torch.no_grad():
        batch = tm(torch.from_numpy(x).long(), tconds).numpy()
    np.testing.assert_allclose(got, batch, rtol=8e-2, atol=8e-2)
    # f32, zero key stabilizer on both paths: the same math up to rounding
    # (the fixed sinusoid is f64-built in the table, f32 in the step)
    np.testing.assert_allclose(got, batch, rtol=2e-5, atol=2e-5, err_msg=name)


# -- the two attention steps -------------------------------------------------

FEATURES = {"softmax": dict(), "generalized": dict(generalized=True),
            "no-projection": dict(projection=None)}


@pytest.mark.parametrize("kind", list(FEATURES))
def test_favor_attention_step_matches_jax(kind):
    rng = np.random.default_rng(3)
    b, h, d, m, steps = 2, 3, 8, 16, 6
    proj = rng.normal(size=(m, d)).astype(np.float32)
    opts = dict(FEATURES[kind])
    p = opts.pop("projection", proj)
    m_state = d if p is None else m
    S_j = jnp.zeros((b, h, m_state, d)), jnp.zeros((b, h, m_state))
    S_t = torch.zeros(b, h, m_state, d), torch.zeros(b, h, m_state)
    for _ in range(steps):
        q, k, v = (rng.normal(size=(b, h, d)).astype(np.float32) for _ in range(3))
        oj, S_j = jfavor.favor_attention_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), S_j,
                                              None if p is None else jnp.asarray(p), **opts)
        ot, S_t = tfavor.favor_attention_step(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), S_t,
                                              None if p is None else torch.from_numpy(p), **opts)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)
        for a, c in zip(S_t, S_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-5)


def test_favor_attention_step_keeps_state_dtype():
    """S and z accumulate in f32 and round to the state's own dtype."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8)).astype(np.float32)) for _ in range(3))
    proj = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    state = torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16), torch.zeros(1, 2, 16,
                                                                         dtype=torch.bfloat16)
    state32 = tuple(x.float() for x in state)
    _, (S, z) = tfavor.favor_attention_step(q, k, v, state, proj)
    _, (S32, z32) = tfavor.favor_attention_step(q, k, v, state32, proj)
    assert S is state[0] and z is state[1]  # updated in place
    assert S.dtype == z.dtype == torch.bfloat16
    torch.testing.assert_close(S, S32.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(z, z32.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotary", [True, False], ids=["rotary", "no-rotary"])
def test_local_attention_step_matches_jax(cache_dtype, rotary):
    """Steps 0 .. 2w + 2: t < window, t = window and a wrapped ring."""
    rng = np.random.default_rng(5)
    b, h, d, w = 2, 2, 8, 5
    ck_j = cv_j = jnp.zeros((b, h, w, d), getattr(jnp, cache_dtype))
    ck_t = torch.zeros(b, h, w, d, dtype=getattr(torch, cache_dtype))
    cv_t = ck_t.clone()
    for t in range(2 * w + 3):
        q, k, v = (rng.normal(size=(b, h, d)).astype(np.float32) for _ in range(3))
        oj, ck_j, cv_j = jlocal.local_attention_step(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ck_j, cv_j, jnp.asarray(t),
            window=w, use_rotary=rotary)
        ot, ck_t2, _ = tlocal.local_attention_step(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), ck_t, cv_t, t,
            window=w, use_rotary=rotary)
        assert ck_t2 is ck_t  # written in place
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5,
                                   err_msg=f"t={t}")
        np.testing.assert_allclose(ck_t.float().numpy(), np.asarray(ck_j, np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")


def test_local_attention_step_matches_batch():
    """The ring step at every position equals the batch local attention."""
    rng = np.random.default_rng(6)
    b, h, n, d, w = 1, 2, 13, 8, 4
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
               for _ in range(3))
    want = tlocal.local_attention(q, k, v, window=w)
    ck, cv = torch.zeros(b, h, w, d), torch.zeros(b, h, w, d)
    for t in range(n):
        o, ck, cv = tlocal.local_attention_step(q[:, :, t], k[:, :, t], v[:, :, t], ck, cv, t,
                                                window=w)
        torch.testing.assert_close(o, want[:, :, t], rtol=1e-5, atol=1e-5)


# -- samplers ----------------------------------------------------------------

GREEDY = ["default", "rotary", "all-local", "bos-replacement", "prepending", "spatial-absolute"]


@pytest.mark.parametrize("name", GREEDY)
def test_exact_greedy_grids_equal_jax(name):
    jm, variables, tm, conds = _named(name)
    ordering = Ordering("raster_scan", 3, GRID)
    with_c = conds is not None
    jsampler = js.make_sampler(jm, ordering, batch=2, do_sample=False, fused=False,
                               with_conditionings=with_c)
    args = ([jnp.asarray(c) for c in conds],) if with_c else ()
    want = np.asarray(jsampler(variables, jax.random.key(0), *args))
    tsampler = ts.make_sampler(tm, ordering, batch=2, do_sample=False, fused=False,
                               with_conditionings=with_c)
    assert not tsampler.fused
    got = tsampler(None, [torch.from_numpy(c) for c in conds] if with_c else None)
    assert got.dtype == torch.int32 and got.shape == (2,) + GRID
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["default", "prepending"])
def test_sample_naive_equals_sample(name):
    _, _, tm, conds = _named(name)
    ordering = Ordering("raster_scan", 3, GRID)
    tconds = None if conds is None else [torch.from_numpy(c) for c in conds]
    fast = ts.sample(tm, ordering, batch=2, conditionings=tconds, do_sample=False)
    naive = ts.sample_naive(tm, ordering, batch=2, conditionings=tconds, do_sample=False)
    torch.testing.assert_close(fast, naive, rtol=0, atol=0)
    assert int(fast.max()) < VOCAB - 1  # BOS never emitted


def test_exact_sampler_draws_from_the_generator():
    _, _, tm, _ = _named("default")
    ordering = Ordering("raster_scan", 3, GRID)
    sampler = ts.make_sampler(tm, ordering, batch=2, temperature=2.0, fused=False)
    a = sampler(torch.Generator().manual_seed(0))
    b = sampler(torch.Generator().manual_seed(0))
    c = sampler(torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
