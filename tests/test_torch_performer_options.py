"""The Performer's forward options in the port (synthanatomy_tpu_torch/
models/performer.py) against the JAX package: rotary, fixed and axial
sequence embeddings, fixed spatial tables, ScaleNorm, the GLU
feed-forward, ``remat_attention`` and ``reversible``.

Small prior: 2 layers, d 32, 4 heads of 8 (2 local, window 6), m 16,
spatial tables over a (2, 3, 4) grid (L 24 + BOS), f32.  Weights come
from the JAX init and cross by ``performer_from_jax``; inputs are made
with numpy.  The port runs both kernel flags on, so on the CPU its
attention goes through the kernels' plain versions.

Tolerances: f32 logits agree to ~1e-6 relative (sums in other orders);
the bound is 2e-5, as in tests/test_torch_train_step.py, and gradients
1e-4 of each tensor's largest magnitude.  Remat and reversible recompute
the same operations on the same inputs, so with dropout on they must
give the gradients of the model without them to 1e-6 of the largest.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.losses.transformer import ce_loss as jce_loss
from synthanatomy_tpu.models.ordering import Ordering
from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu.models.sampling import combined_position_table as j_position_table
from synthanatomy_tpu_torch.interop import performer_from_jax
from synthanatomy_tpu_torch.losses.transformer import ce_loss
from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.models.sampling import make_sampler

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRID = (2, 3, 4)
L = 24
VOCAB = 17
DEPTH = 2
DIM = 32

OPTIONS = {
    "rotary": dict(rotary_position_emb=True),
    "fixed": dict(fixed_position_emb=True),
    "axial": dict(axial_position_emb=True),
    "axial-shape": dict(axial_position_emb=True, axial_position_shape=(5, 5)),
    "scalenorm": dict(use_scalenorm=True),
    "glu": dict(ff_glu=True),
    "spatial-fixed": dict(spatial_position_emb="fixed"),
    "remat": dict(remat_attention=True),
    "reversible": dict(reversible=True),
    "rotary-glu-scalenorm-remat": dict(rotary_position_emb=True, ff_glu=True,
                                       use_scalenorm=True, remat_attention=True),
}


def _config(**extra):
    kw = dict(heads=4, dim_head=8, local_attn_heads=2, local_window_size=6, nb_features=16,
              spatial_position_emb="absolute", spatial_shape=GRID,
              ordering=Ordering("raster_scan", 3, GRID), scan_chunk=8)
    kw.update(extra)
    return kw


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB - 1, size=(2, L + 1)).astype(np.int32)
    x[:, 0] = VOCAB - 1
    return x, np.roll(x, -1, axis=1)


def _models(**extra):
    kw = _config(**extra)
    jm = JPerformer(num_tokens=VOCAB, max_seq_len=L + 1, dim=DIM, depth=DEPTH,
                    dtype=jnp.float32, attn_compute_dtype=jnp.float32, use_pallas_local=True,
                    use_pallas_favor=True, **kw)
    inputs, _ = _batch()
    variables = jax.jit(jm.init)({"params": jax.random.key(0), "favor": jax.random.key(1)},
                                 jnp.asarray(inputs))
    params = jax.device_get(variables["params"])
    favor = jax.device_get(variables.get("favor", {}))
    tm = _port(params, favor, **kw)
    return jm, params, favor, tm


def _port(params, favor, **kw):
    return performer_from_jax(params, favor, DEPTH, device="cpu", dtype=torch.float32,
                              attn_compute_dtype=torch.float32, use_pallas_local=True,
                              use_pallas_favor=True, max_seq_len=L + 1, **kw)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_forward_matches_jax(name):
    jm, params, favor, tm = _models(**OPTIONS[name])
    inputs, _ = _batch()
    want = np.asarray(jax.jit(jm.apply)({"params": params, "favor": favor}, jnp.asarray(inputs)))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.tensor(inputs)).numpy()
    assert got.shape == (2, L + 1, VOCAB)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["rotary", "axial", "scalenorm", "glu", "spatial-fixed",
                                  "remat", "reversible"])
def test_option_gradients_match_jax(name):
    jm, params, favor, tm = _models(**OPTIONS[name])
    inputs, targets = _batch(1)

    def loss_fn(p):
        logits = jm.apply({"params": p, "favor": favor}, jnp.asarray(inputs))
        return jce_loss(logits, jnp.asarray(targets))[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = ce_loss(tm(torch.tensor(inputs)), torch.tensor(targets))[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    want = _port(jax.device_get(j_grads), favor, **_config(**OPTIONS[name]))
    for (n, p), (_, w) in zip(tm.named_parameters(), want.named_parameters()):
        scale = max(float(w.detach().abs().max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("name", ["fixed", "axial", "spatial-fixed"])
def test_position_table_matches_jax(name):
    """The per-token rows the fused sampler adds equal JAX's
    ``combined_position_table`` for the fixed and axial tables."""
    jm, params, favor, tm = _models(**OPTIONS[name])
    want = np.asarray(j_position_table(jm, {"params": params, "favor": favor}, L + 1))
    np.testing.assert_allclose(tm.position_table(L + 1).detach().numpy(), want, rtol=0,
                               atol=1e-6)


def _dropout_grads(params, favor, seed, **kw):
    """Loss, gradients and the generator's state after one train-mode
    forward + backward with dropout on, drawing from a seeded explicit
    generator."""
    tm = _port(params, favor, emb_dropout=0.1, attn_dropout=0.2, ff_dropout=0.3, **kw)
    gen = torch.Generator().manual_seed(seed)
    tm.set_generator(gen)
    tm.train()
    inputs, targets = _batch(2)
    loss = ce_loss(tm(torch.tensor(inputs)), torch.tensor(targets))[0]
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in tm.named_parameters()}, gen.get_state()


@pytest.mark.parametrize("name", ["remat", "reversible", "remat+reversible"])
def test_remat_with_dropout_matches_plain_model(name):
    """checkpoint restores only torch's default generators; the port sets
    the explicit dropout generator back for the recompute, so the
    recompute draws the forward's masks and the gradients equal those of
    the model without remat.  The generator ends where it would without
    remat."""
    flags = ({"remat_attention": True, "reversible": True} if name == "remat+reversible"
             else OPTIONS[name])
    _, params, favor, _ = _models()
    loss0, g0, s0 = _dropout_grads(params, favor, 5, **_config())
    loss1, g1, s1 = _dropout_grads(params, favor, 5, **_config(**flags))
    assert loss1 == loss0
    assert torch.equal(s0, s1)
    for n in g0:
        scale = max(float(g0[n].abs().max()), 1e-30)
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6 * scale, msg=n)
    # another seed draws other masks: the comparison above is not vacuous
    loss2, _, _ = _dropout_grads(params, favor, 6, **_config(**flags))
    assert loss2 != loss0


def test_position_embeddings_are_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        Performer(VOCAB, L + 1, DIM, 1, heads=4, dim_head=8, rotary_position_emb=True,
                  axial_position_emb=True, device="cpu")
    with pytest.raises(ValueError, match="'fixed' or 'absolute'"):
        Performer(VOCAB, L + 1, DIM, 1, heads=4, dim_head=8, spatial_position_emb="learned",
                  spatial_shape=GRID, ordering=Ordering("raster_scan", 3, GRID), device="cpu")


@pytest.mark.parametrize("flag", ["rotary_position_emb", "use_scalenorm", "ff_glu"])
def test_fused_sampler_refuses_what_it_does_not_cover(flag):
    """The fused decode step covers neither per-layer rotary, ScaleNorm
    nor the GLU feed-forward: ``fused=True`` refuses such a prior, and
    ``"auto"`` samples it through the exact decode_step path."""
    model = Performer(VOCAB, L + 1, 128, 1, heads=2, dim_head=64, local_attn_heads=1,
                      local_window_size=6, device="cpu", **{flag: True})
    ordering = Ordering("raster_scan", 3, GRID)
    with pytest.raises(ValueError, match="fused"):
        make_sampler(model, ordering, fused=True)
    sampler = make_sampler(model, ordering, do_sample=False)
    assert not sampler.fused
    grid = sampler(None)
    assert grid.shape == (1,) + GRID and int(grid.max()) < VOCAB - 1
