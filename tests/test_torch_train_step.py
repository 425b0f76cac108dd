"""Port prior training path (synthanatomy_tpu_torch/models/performer.py
forward, losses/transformer.py, train/transformer_steps.py,
runners/transformer.py::prepare_batch) against the JAX package.

Small prior: 2 layers, d 64, 4 heads of 16 (2 local, window 6), m 32,
learned spatial tables over a (2, 3, 4) grid (L 24), scan chunk 8.
Weights come from the JAX init and cross by ``performer_from_jax``; the
ReZero gains are set non-zero (at zero every block weight has a zero
gradient).  The port runs with both kernel flags on, so on the CPU its
attention goes through the kernels' plain versions; JAX on the CPU runs
its XLA paths, which compute the same function.

Tolerances: f32 logits and gradients agree to ~1e-6 relative (sums in
other orders); the stated bounds are 2e-5 on logits and 1e-4 of each
gradient's largest magnitude.  bf16 logits differ by a few bf16 ulps
(2^-8 relative) where the two frameworks round a product or a GELU the
other way; bound: 0.1 absolute on logits of magnitude ~3 and 1e-2 in
norm.  Adam's first update is lr·g/(|g| + eps) ≈ lr·sign(g): it is
compared only where |g| is well above f32 noise, to 1e-3 of lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthanatomy_tpu.losses.transformer import ce_loss as jce_loss
from synthanatomy_tpu.models.ordering import Ordering
from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu.runners.transformer import prepare_batch as jprepare_batch
from synthanatomy_tpu.train.transformer_steps import (
    TransformerTrainState as JState,
    make_transformer_train_step as jmake_step,
)
from synthanatomy_tpu_torch.interop import performer_from_jax
from synthanatomy_tpu_torch.losses.transformer import ce_loss
from synthanatomy_tpu_torch.models.performer import Performer, redraw_projections
from synthanatomy_tpu_torch.runners.transformer import prepare_batch
from synthanatomy_tpu_torch.train.transformer_steps import (
    create_transformer_train_state,
    make_transformer_eval_step,
    make_transformer_train_step,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRID = (2, 3, 4)
L = 24
VOCAB = 17
DEPTH = 2
LR = 1e-3


def _config(rezero, cond):
    kw = dict(heads=4, dim_head=16, local_attn_heads=2, local_window_size=6,
              nb_features=32, use_rezero=rezero, spatial_position_emb="absolute",
              spatial_shape=GRID, ordering=Ordering("raster_scan", 3, GRID), scan_chunk=8)
    if cond:
        kw.update(conditioning_num_tokens=(3, 5), conditioning_type=cond)
    return kw


def _batch(cond, seed=0):
    rng = np.random.default_rng(seed)
    latents = rng.integers(0, VOCAB - 1, size=(2,) + GRID)
    inputs, targets = jprepare_batch(latents, Ordering("raster_scan", 3, GRID), VOCAB - 1)
    conds = ([rng.integers(0, 3, size=(2,)).astype(np.int32),
              rng.integers(0, 5, size=(2,)).astype(np.int32)] if cond else None)
    return inputs, targets, conds


def _models(rezero, cond, dtype, **extra):
    """JAX model and variables, and the port model loaded from them."""
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    kw = dict(_config(rezero, cond), **extra)
    jm = JPerformer(num_tokens=VOCAB, max_seq_len=L + 1, dim=64, depth=DEPTH, dtype=jd,
                    attn_compute_dtype=jd, use_pallas_local=True, use_pallas_favor=True,
                    **kw)
    inputs, _, conds = _batch(cond)
    variables = jax.jit(jm.init)({"params": jax.random.key(0), "favor": jax.random.key(1)},
                                 jnp.asarray(inputs), conds)
    params = jax.device_get(variables["params"])
    favor = jax.device_get(variables.get("favor", {}))
    if rezero:
        params = dict(params)
        for i in range(DEPTH):
            blk = dict(params[f"block_{i}"])
            blk["g_attn"] = np.asarray([0.7], np.float32)
            blk["g_ff"] = np.asarray([0.5], np.float32)
            params[f"block_{i}"] = blk
    tm = performer_from_jax(params, favor, DEPTH, device="cpu", dtype=td, attn_compute_dtype=td,
                            use_pallas_local=True, use_pallas_favor=True, **kw)
    return jm, params, favor, tm, kw


def _torch_conds(conds):
    return None if conds is None else [torch.tensor(c) for c in conds]


@pytest.mark.parametrize("rezero,cond,dtype,extra", [
    (True, "bos_replacement", "f32", {}),
    (False, "prepending", "f32", {}),
    (True, None, "bf16", {}),
    (False, "prepending", "bf16", {}),
    (False, None, "f32", dict(qkv_bias=True, attn_out_bias=True, generalized_attention=True)),
    (True, None, "f32", dict(no_projection=True, tie_embed=True)),
], ids=["rezero-bos-f32", "preln-prepend-f32", "rezero-bf16", "preln-prepend-bf16",
        "bias-generalized-f32", "no-projection-tied-f32"])
def test_forward_matches_jax(rezero, cond, dtype, extra):
    """Both conditioning types, ReZero and pre-LN, f32 and bf16; and the
    options that route FAVOR heads off the kernel (generalized features,
    no projection), q/k/v/out biases and the tied output head."""
    jm, params, favor, tm, _ = _models(rezero, cond, dtype, **extra)
    inputs, _, conds = _batch(cond)
    want = np.asarray(jax.jit(jm.apply)({"params": params, "favor": favor},
                                        jnp.asarray(inputs), conds).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.tensor(inputs), _torch_conds(conds))
        enc = tm(torch.tensor(inputs), _torch_conds(conds), return_encodings=True)
    assert enc.shape == (2, L, 64)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = got.float().numpy()
    assert got.shape == (2, L, VOCAB)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1)
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def _by_name(tree, favor, kw):
    """A JAX parameter-shaped tree as the port's {name: numpy} (through
    the same transposes as the weights)."""
    m = performer_from_jax(tree, favor, DEPTH, device="cpu", **kw)
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


@pytest.mark.parametrize("rezero,cond", [(True, None), (False, "bos_replacement")])
def test_train_step_matches_jax(rezero, cond):
    """One step at f32: loss, every parameter's gradient, and the
    parameters after Adam, against JAX's make_transformer_train_step."""
    jm, params, favor, tm, kw = _models(rezero, cond, "f32")
    inputs, targets, conds = _batch(cond)

    def loss_fn(p):
        logits = jm.apply({"params": p, "favor": favor}, jnp.asarray(inputs), conds)
        return jce_loss(logits, jnp.asarray(targets))[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params, favor=favor,
                    opt_state=tx.init(params), rng=jax.random.key(3))
    jstate, jmetrics = jax.jit(jmake_step(jm, tx))(
        jstate, jnp.asarray(inputs), jnp.asarray(targets), conds, {"lr": LR})
    np.testing.assert_allclose(float(jmetrics["Loss"]), float(j_loss), rtol=1e-6)

    before = {k: v.detach().clone().numpy() for k, v in tm.named_parameters()}
    state = create_transformer_train_state(tm, seed=0, learning_rate=0.5)
    step = make_transformer_train_step(tm)
    state, metrics = step(state, torch.tensor(inputs), torch.tensor(targets),
                          _torch_conds(conds), {"lr": LR})
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["Loss"]), float(j_loss), rtol=1e-5)

    grads = _by_name(jax.device_get(j_grads), favor, kw)
    after = _by_name(jax.device_get(jstate.params), favor, kw)
    n_checked = 0
    for name, p in tm.named_parameters():
        g_t, g_j = p.grad.numpy(), grads[name]
        scale = max(float(np.abs(g_j).max()), 1e-30)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * scale, err_msg=name)
        upd_t, upd_j = p.detach().numpy() - before[name], after[name] - before[name]
        big = np.abs(g_j) > max(1e-6, 1e-3 * scale)
        np.testing.assert_allclose(upd_t[big], upd_j[big], rtol=0, atol=1e-3 * LR,
                                   err_msg=name)
        assert np.abs(upd_t).max() <= LR * 1.001, name
        n_checked += int(big.sum())
    assert n_checked > 0.5 * sum(p.numel() for p in tm.parameters())


def test_ce_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    mask = (rng.uniform(size=(2, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jce_loss(jnp.asarray(logits), jnp.asarray(targets),
                        mask=None if m is None else jnp.asarray(m))[0]
        got = ce_loss(torch.tensor(logits).to(torch.bfloat16), torch.tensor(targets),
                      mask=None if m is None else torch.tensor(m))[0]
        want_bf = jce_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets),
                           mask=None if m is None else jnp.asarray(m))[0]
        np.testing.assert_allclose(float(got), float(want_bf), rtol=1e-6)
        got32 = ce_loss(torch.tensor(logits), torch.tensor(targets),
                        mask=None if m is None else torch.tensor(m))[0]
        np.testing.assert_allclose(float(got32), float(want), rtol=1e-6)


def test_prepare_batch_matches_jax():
    rng = np.random.default_rng(5)
    latents = rng.integers(0, 2048, size=(3, 4, 5, 2)).astype(np.uint16)
    order = Ordering("raster_scan", 3, (4, 5, 2))
    for a, b in zip(prepare_batch(latents, order, 2048),
                    jprepare_batch(latents, order, 2048)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_redraw_and_eval_step():
    """Redraws replace every projection with a fresh orthogonal draw, from
    the state's generator (so a seed repeats it); the eval step returns
    the forward's logits and loss, without dropout."""
    kw = _config(True, None)
    model = Performer(VOCAB, L + 1, 64, DEPTH, emb_dropout=0.5, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0), **kw)
    old = [b.attn.projection.clone() for b in model.blocks]
    redraw_projections(model, torch.Generator().manual_seed(7))
    new = [b.attn.projection.clone() for b in model.blocks]
    for a, b in zip(old, new):
        assert not torch.equal(a, b)
        blk = b / b.norm(dim=1, keepdim=True)
        torch.testing.assert_close(blk[:16] @ blk[:16].T, torch.eye(16), atol=1e-5, rtol=0)
    redraw_projections(model, torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b.attn.projection) for a, b in zip(new, model.blocks))

    inputs, targets, _ = _batch(None)
    state = create_transformer_train_state(model, seed=1)
    logits, metrics = make_transformer_eval_step(model)(
        state, torch.tensor(inputs), torch.tensor(targets))
    model.eval()
    with torch.no_grad():
        want = model(torch.tensor(inputs))
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    torch.testing.assert_close(metrics["Loss"], ce_loss(want, torch.tensor(targets))[0])


@pytest.mark.parametrize("flag", ["rotary_position_emb", "fixed_position_emb",
                                  "axial_position_emb", "use_scalenorm", "ff_glu",
                                  "reversible", "remat_attention"])
def test_unported_options_raise(flag):
    """These options once raised at construction; they are ported now
    (each is held against JAX in tests/test_torch_performer_options.py),
    so the model builds and runs a finite forward.  What stays unported
    behind them was the exact decode_step sampler; it is ported too, so a
    prior the fused step does not cover (per-layer rotary, ScaleNorm, GLU)
    makes ``fused=True`` raise and ``"auto"`` take the exact path."""
    model = Performer(VOCAB, L + 1, 128, 1, heads=2, dim_head=64, local_attn_heads=1,
                      local_window_size=6, device="cpu", dtype=torch.float32, **{flag: True})
    inputs, _, _ = _batch(None)
    with torch.no_grad():
        assert torch.isfinite(model(torch.tensor(inputs))).all()
    if flag in ("rotary_position_emb", "use_scalenorm", "ff_glu"):
        from synthanatomy_tpu_torch.models.sampling import make_sampler

        with pytest.raises(ValueError, match="fused"):
            make_sampler(model, Ordering("raster_scan", 3, GRID), fused=True)
        assert not make_sampler(model, Ordering("raster_scan", 3, GRID)).fused


def test_dropout_draws_from_the_generator():
    """flax's Dropout: identity in eval mode; in train mode each value is
    kept with probability 1 − rate and scaled by 1/(1 − rate), with draws
    from the generator the train state hands the model."""
    from synthanatomy_tpu_torch.models.performer import Dropout

    drop = Dropout(0.25)
    x = torch.rand(4096) + 1.0
    drop.eval()
    assert torch.equal(drop(x), x)
    drop.train()
    outs = []
    for _ in range(2):
        drop.generator = torch.Generator().manual_seed(3)
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    kept = outs[0] != 0
    torch.testing.assert_close(outs[0][kept], x[kept] / 0.75)
    assert 0.7 < float(kept.float().mean()) < 0.8
