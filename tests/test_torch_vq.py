"""Port VQ (synthanatomy_tpu_torch/ops/vq.py) and orderings against the
JAX package on the CPU: the nearest-codeword plain twins against JAX's
XLA path and its Pallas kernels in interpret mode, ``quantize_ema``
(indices, loss, EMA state, straight-through gradient), ``perplexity``,
and the port's copy of the orderings.  Inputs come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.models import ordering as jordering
from synthanatomy_tpu.ops import vq as jvq
from synthanatomy_tpu_torch.models import ordering as tordering
from synthanatomy_tpu_torch.ops import vq

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _data(n, k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", [(300, 64, 8), (77, 130, 32), (513, 300, 5)])
def test_nearest_codeword_plain_matches_jax(n, k, d):
    x, w = _data(n, k, d, n + k)
    got = vq.nearest_codeword(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    # f32 on both sides; random data has no near-ties at this size
    np.testing.assert_array_equal(got, np.asarray(jvq._nearest_codeword_xla(x, w)))
    np.testing.assert_array_equal(
        got, np.asarray(jvq.nearest_codeword_pallas(x, w, interpret=True)))


def test_nearest_codeword_ties_go_to_the_lower_index():
    w = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]], np.float32)
    x = np.array([[1.0, 1.0], [2.0, 0.0]], np.float32)  # rows tie 0/1, then 0/2
    got = vq.nearest_codeword(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, [0, 0])
    np.testing.assert_array_equal(got, np.asarray(jvq._nearest_codeword_xla(x, w)))


def test_nearest_codeword_stats_plain_matches_pallas_interpret():
    x, w = _data(700, 96, 16, 3)
    idx, counts, dw = vq.nearest_codeword_stats(torch.from_numpy(x), torch.from_numpy(w))
    j_idx, j_counts, j_dw = jvq.nearest_codeword_stats_pallas(x, w, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))  # exact integers
    # f32 sums of up to ~20 rows in other orders
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=1e-5, atol=1e-5)


def _state(k, d, seed):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    cs = rng.uniform(0.0, 3.0, size=(k,)).astype(np.float32)
    ea = (cb * rng.uniform(0.5, 1.5, size=(k, 1))).astype(np.float32)
    jstate = jvq.VQState(jnp.asarray(cb), jnp.asarray(cs), jnp.asarray(ea))
    tstate = vq.init_vq_state(k, d, device="cpu")
    for name, v in (("codebook", cb), ("cluster_size", cs), ("embed_avg", ea)):
        getattr(tstate, name).copy_(torch.from_numpy(v))
    return jstate, tstate


@pytest.mark.parametrize("fused_stats", [False, True])
def test_quantize_ema_matches_jax(monkeypatch, fused_stats):
    k, d = 32, 8
    jstate, tstate = _state(k, d, 1)
    x = np.random.default_rng(2).normal(size=(2, 3, 4, 5, d)).astype(np.float32)
    monkeypatch.setattr(vq, "FUSED_EMA_STATS", fused_stats)
    jq, jl, ji, jnew = jvq.quantize_ema(jstate, jnp.asarray(x), decay=0.5, commitment_cost=0.25,
                                        training=True, use_pallas=False)
    tq, tl, ti, tnew = vq.quantize_ema(tstate, torch.from_numpy(x), decay=0.5,
                                       commitment_cost=0.25, training=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for name in ("codebook", "cluster_size", "embed_avg"):  # f32, sums in other orders
        np.testing.assert_allclose(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
                                   rtol=1e-5, atol=1e-6)


def test_quantize_ema_eval_keeps_state_and_bf16():
    jstate, tstate = _state(16, 4, 4)
    before = tstate.codebook.clone()
    x = np.random.default_rng(5).normal(size=(2, 6, 4)).astype(np.float32)
    tq, _, ti, _ = vq.quantize_ema(tstate, torch.from_numpy(x).to(torch.bfloat16), decay=0.5,
                                   commitment_cost=0.25, training=False)
    _, _, ji, _ = jvq.quantize_ema(jstate, jnp.asarray(x, jnp.bfloat16), decay=0.5,
                                   commitment_cost=0.25, training=False, use_pallas=False)
    assert tq.dtype == torch.bfloat16
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert torch.equal(tstate.codebook, before)


def test_straight_through_gradient_matches_jax():
    jstate, tstate = _state(16, 4, 6)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    g = rng.normal(size=(3, 5, 4)).astype(np.float32)

    def jloss(xx):
        q, loss, _, _ = jvq.quantize_ema(jstate, xx, decay=0.5, commitment_cost=0.25,
                                         training=False, use_pallas=False)
        return jnp.sum(q * g) + loss

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    q, loss, _, _ = vq.quantize_ema(tstate, xt, decay=0.5, commitment_cost=0.25, training=False)
    (torch.sum(q * torch.from_numpy(g)) + loss).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_perplexity_matches_jax():
    idx = np.random.default_rng(8).integers(0, 20, size=(4, 7)).astype(np.int32)
    np.testing.assert_allclose(float(vq.perplexity(torch.from_numpy(idx), 32)),
                               float(jvq.perplexity(jnp.asarray(idx), 32)), rtol=1e-6)


@pytest.mark.parametrize("init", ["normal", "kaiming_uniform"])
def test_init_vq_state(init):
    st = vq.init_vq_state(64, 8, init, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert st.codebook.shape == (64, 8) and st.codebook.dtype == torch.float32
    assert torch.equal(st.codebook, st.embed_avg) and not st.cluster_size.any()
    if init == "kaiming_uniform":
        assert float(st.codebook.abs().max()) <= (3.0 * 2.0 / 8) ** 0.5


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        vq.nearest_codeword(x, torch.zeros(16, 8, device="meta"))
    with pytest.raises(ValueError):
        vq.nearest_codeword_stats(x, torch.zeros(16, 8, device="meta"))


@pytest.mark.parametrize("kind,extra", [
    ("raster_scan", {}),
    ("s_curve", {"rot90_axes": ((0, 1),)}),
    ("hilbert_curve", {"transpositions_axes": ((1, 0, 2),)}),
    ("random", {"reflected_spatial_dims": (True, False, True), "seed": 3}),
])
def test_ordering_copy_matches_jax(kind, extra):
    j = jordering.Ordering(kind, 3, (3, 4, 5), **extra)
    t = tordering.Ordering(kind, 3, (3, 4, 5), **extra)
    np.testing.assert_array_equal(t.get_sequence_ordering(), j.get_sequence_ordering())
    np.testing.assert_array_equal(t.get_revert_sequence_ordering(),
                                  j.get_revert_sequence_ordering())
    assert list(tordering.gilbert3d(4, 3, 2)) == list(jordering.gilbert3d(4, 3, 2))
    assert tordering.ORDERING_TYPES == jordering.ORDERING_TYPES
