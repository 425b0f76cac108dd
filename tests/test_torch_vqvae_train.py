"""Port stage 1 against the JAX package on the CPU, at small size and f32:
the VQ-VAE's encode / index_quantize / forward (fused residual route
forced on, with and without remat and sub-pixel upsampling), the ten
reconstruction losses, LPIPS (alex, squeeze), the discriminator (train,
eval, split batch norm), the adversarial criteria, and one whole G + D
train step (losses, every G and D gradient, the Adam update, the EMA
codebook and D's batch statistics).  Weights cross by ``interop``; the
port's NCDHW volumes are permuted to JAX's NDHWC.  Also: the port
imports no JAX, and its entry points default to the card."""

import ast
import os
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthanatomy_tpu.losses import adversarial as jadv
from synthanatomy_tpu.losses import lpips as jlpips
from synthanatomy_tpu.losses import vqvae as jlosses
from synthanatomy_tpu.models.discriminator import BaselineDiscriminator as JDisc
from synthanatomy_tpu.models.vqvae import BaselineVQVAE as JVQVAE
from synthanatomy_tpu.train.vqvae_steps import make_vqvae_train_step as j_make_step
from synthanatomy_tpu_torch.interop import discriminator_from_jax, lpips_from_jax, vqvae_from_jax
from synthanatomy_tpu_torch.losses import adversarial as tadv
from synthanatomy_tpu_torch.losses import lpips as tlpips
from synthanatomy_tpu_torch.losses import vqvae as tlosses
from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
from synthanatomy_tpu_torch.train.vqvae_steps import (
    create_vqvae_train_state,
    make_vqvae_eval_step,
    make_vqvae_train_step,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DOWN = ((4, 2, 1, 1),) * 2
UP = ((4, 2, 1, 0, 1),) * 2
SCHED = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25, "gdl_factor": 0.5,
         "epoch": 0}


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _apply(jm, method):
    """jitted eval-mode apply of a JAX VQ-VAE method (None: __call__)"""
    if method is None:
        return jax.jit(lambda v, x: jm.apply(v, x, training=False))
    return jax.jit(lambda v, x: jm.apply(v, x, method=getattr(jm, method)))


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (name, err, np.abs(want).max())


def _models(remat=False, subpixel=False):
    kw = dict(n_levels=2, downsample_parameters=DOWN, upsample_parameters=UP, n_embed=16,
              embed_dim=4, n_channels=8, n_res_channels=8, n_res_layers=1, dtype=jnp.float32,
              use_remat=remat, use_subpixel_conv=subpixel)
    jm = JVQVAE(**kw)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.key(1), jnp.zeros((1, 8, 8, 8, 1))))
    tm = vqvae_from_jax(variables["params"], variables["vq"], 2, 1, downsample_parameters=DOWN,
                        upsample_parameters=UP, dtype=torch.float32, use_remat=remat,
                        use_subpixel_conv=subpixel, use_fused_residual=True, device="cpu")
    return jm, variables, tm


@pytest.mark.parametrize("subpixel", [False, True])
def test_vqvae_encode_index_forward_match_jax(subpixel):
    jm, variables, tm = _models(subpixel=subpixel)
    assert all(layer.fused(torch.zeros(1, 4, 4, 4, 4), True) for layer in tm.encoder_res[0])
    x = np.random.default_rng(0).uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    xt = _ncdhw(x)
    with torch.no_grad():
        _close(_ndhwc(tm.encode(xt)[0]), _apply(jm, "encode")(variables, x)[0], 1e-5, "encode")
        got_idx = tm.index_quantize(xt)[0].numpy()
        want_idx = np.asarray(_apply(jm, "index_quantize")(variables, x)[0])
        np.testing.assert_array_equal(got_idx, want_idx)
        out = tm(xt, training=False)
    jout = _apply(jm, None)(variables, x)
    _close(_ndhwc(out["reconstruction"][0]), jout["reconstruction"][0], 1e-5, "recon")
    _close(float(out["quantization_losses"][0]), float(jout["quantization_losses"][0]), 1e-5)


def test_vqvae_training_forward_updates_codebook_like_jax():
    jm, variables, tm = _models(remat=True)
    x = np.random.default_rng(1).uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    out = tm(_ncdhw(x), training=True, decay=0.5, commitment_cost=0.25)
    jout, muts = jax.jit(lambda v, xx: jm.apply(v, xx, training=True, decay=0.5,
                                                commitment_cost=0.25,
                                                mutable=["vq", "diagnostics"]))(variables, x)
    _close(_ndhwc(out["reconstruction"][0]), jout["reconstruction"][0], 1e-5, "recon")
    new = muts["vq"]["level_0"]
    for name in ("codebook", "cluster_size", "embed_avg"):
        _close(getattr(tm.vq, name).numpy(), getattr(new, name), 1e-5, name)
    _close(float(tm.diagnostics["perplexity"]), float(muts["diagnostics"]["perplexity"]), 1e-6)
    _close(_ndhwc(tm.diagnostics["last_layer_input"]),
           muts["diagnostics"]["last_layer_input"], 1e-5, "last layer input")
    assert tm.last_layer_name() == jm.last_layer_name() == "decoder_up_1"


@pytest.fixture(scope="module")
def lpips_pair():
    out = {}
    for net in ("alex", "squeeze"):
        jp = jax.jit(jlpips.init_lpips_params, static_argnums=1)(jax.random.key(7), net)
        out[net] = (jp, lpips_from_jax(jax.device_get(jp), device="cpu"))
    return out


@pytest.mark.parametrize("net", ["alex", "squeeze"])
def test_lpips_distance_matches_jax(lpips_pair, net):
    jp, tp = lpips_pair[net]
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(size=(3, 32, 40, 1)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(jlpips.lpips_distance)(jp, jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.lpips_distance(tp, torch.from_numpy(a).permute(0, 3, 1, 2),
                                torch.from_numpy(b).permute(0, 3, 1, 2)).numpy()
    _close(got, want, 1e-4, net)


@pytest.mark.parametrize("name", jlosses.VQVAE_LOSS_NAMES)
def test_losses_match_jax(lpips_pair, name):
    """Every loss and summary, at f32; the perceptual ones keep every
    slice (rng None on both sides)."""
    rng = np.random.default_rng(3)
    y = rng.uniform(size=(1, 32, 32, 32, 1)).astype(np.float32)
    p = (y + 0.1 * rng.normal(size=y.shape)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if name == "baur":
        kw_j["gdl_factor"] = kw_t["gdl_factor"] = 0.5
    if jlosses.loss_needs_lpips(name):
        jp, tp = lpips_pair[jlosses.lpips_net_for_loss(name)]
        kw_j["lpips_params"], kw_t["lpips_params"] = jp, tp
    want, wsum = jax.jit(lambda pp, yy, kw: jlosses.get_vqvae_loss(name)(
        {"reconstruction": [pp], "quantization_losses": [jnp.asarray(0.01)]}, yy, **kw))(
        jnp.asarray(p), jnp.asarray(y), kw_j)
    got, gsum = tlosses.get_vqvae_loss(name)(
        {"reconstruction": [_ncdhw(p)], "quantization_losses": [torch.tensor(0.01)]},
        _ncdhw(y), **kw_t)
    assert set(gsum) == set(wsum)
    for k in wsum:  # f32 FFTs and LPIPS sum in other orders
        _close(float(gsum[k]), float(wsum[k]), 1e-4, k)
    _close(float(got), float(want), 1e-4, "total")
    assert tlosses.loss_needs_lpips(name) == jlosses.loss_needs_lpips(name)
    assert tlosses.lpips_net_for_loss(name) == jlosses.lpips_net_for_loss(name)


@pytest.mark.parametrize("criterion", ["vanilla", "hinge", "least_square"])
def test_adversarial_criteria_match_jax(criterion):
    rng = np.random.default_rng(4)
    f, r = (rng.normal(size=(2, 1, 3, 3, 3)).astype(np.float32) for _ in range(2))
    jg, _ = jadv.generator_loss(jnp.asarray(f), criterion=criterion)
    tg, _ = tadv.generator_loss(torch.from_numpy(f), criterion=criterion)
    jd, _ = jadv.discriminator_loss(jnp.asarray(f), jnp.asarray(r), criterion=criterion)
    td, _ = tadv.discriminator_loss(torch.from_numpy(f), torch.from_numpy(r), criterion=criterion)
    _close(float(tg), float(jg), 1e-6)
    _close(float(td), float(jd), 1e-6)


@pytest.mark.parametrize("split", [False, True])
def test_discriminator_matches_jax(split):
    jd = JDisc(ndf=4, dtype=jnp.float32, use_split_bn=split)
    dv = jax.device_get(jax.jit(lambda k, xx: jd.init(k, xx, training=True))(
        jax.random.key(5), jnp.zeros((2, 24, 24, 24, 1))))
    td = discriminator_from_jax(dv["params"], dv["batch_stats"], dtype=torch.float32,
                                use_split_bn=split, device="cpu")
    x = np.random.default_rng(6).uniform(size=(4, 24, 24, 24, 1)).astype(np.float32)
    with torch.no_grad():
        _close(_ndhwc(td(_ncdhw(x), training=False)),
               jax.jit(lambda v, xx: jd.apply(v, xx, training=False))(dv, x), 1e-5, "eval")
        groups = 2 if split else 1
        got = td(_ncdhw(x), training=True, stat_groups=groups)
    want, m = jax.jit(lambda v, xx: jd.apply(v, xx, training=True, stat_groups=groups,
                                             mutable=["batch_stats"]))(dv, x)
    _close(_ndhwc(got), want, 1e-4, "train")
    for n in (1, 2, 3):
        for k in ("mean", "var"):
            _close(getattr(getattr(td, f"norm_{n}"), k).numpy(), m["batch_stats"][f"norm_{n}"][k],
                   1e-4, f"norm_{n}.{k}")


class _Capture(NamedTuple):
    hyperparams: dict
    g: Any


def _capture_tx():
    """An optax transformation that changes nothing and keeps the last
    gradients in its state, so the JAX step hands them back."""
    def init(p):
        return _Capture({"learning_rate": jnp.zeros(())}, jax.tree.map(jnp.zeros_like, p))

    def update(g, s, p=None):
        return jax.tree.map(jnp.zeros_like, g), _Capture(s.hyperparams, g)

    return optax.GradientTransformation(init, update)


@pytest.mark.parametrize("adaptive,remat,grouped", [(True, True, False), (False, False, True)])
def test_train_step_matches_jax(adaptive, remat, grouped):
    """One G + D step (jukebox loss, least-square criteria, weight 0.005):
    metrics, every G and D gradient, EMA state and D batch statistics
    against JAX's step; the Adam update against optax's formula on the
    port's gradients.  f32; tolerances cover summation order."""
    jm, variables, tm = _models(remat=remat)
    jd = JDisc(ndf=4, dtype=jnp.float32, use_split_bn=grouped)
    x = np.random.default_rng(7).uniform(size=(2, 24, 24, 24, 1)).astype(np.float32)
    dv = jax.device_get(jax.jit(lambda k, xx: jd.init(k, xx, training=True))(
        jax.random.key(8), x))
    td = discriminator_from_jax(dv["params"], dv["batch_stats"], dtype=torch.float32,
                                use_split_bn=grouped, device="cpu")

    from synthanatomy_tpu.train.vqvae_steps import VQVAETrainState as JState

    cap = _capture_tx()
    jstate = JState(step=jnp.zeros((), jnp.int32), g_params=variables["params"],
                    g_opt_state=cap.init(variables["params"]), vq=variables["vq"],
                    rng=jax.random.key(0), d_params=dv["params"],
                    d_batch_stats=dv["batch_stats"], d_opt_state=cap.init(dv["params"]))
    jstep = jax.jit(j_make_step(jm, cap, loss_name="jukebox", d_model=jd, d_tx=cap,
                                use_adaptive_weight=adaptive, d_grouped_stats=grouped))
    jnew, jmet = jstep(jstate, jnp.asarray(x), {k: jnp.asarray(v) for k, v in SCHED.items()})

    state = create_vqvae_train_state(tm, 0, d_model=td, device="cpu")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state, met = make_vqvae_train_step(tm, loss_name="jukebox", d_model=td,
                                       use_adaptive_weight=adaptive,
                                       d_grouped_stats=grouped)(state, _ncdhw(x), SCHED)
    assert state.step == 1
    for k, v in jmet.items():
        _close(float(met[k]), float(v), 1e-4, k)

    want_g = vqvae_from_jax(jax.device_get(jnew.g_opt_state.g), variables["vq"], 2, 1,
                            downsample_parameters=DOWN, upsample_parameters=UP,
                            dtype=torch.float32, device="cpu")
    for n, p in want_g.named_parameters():
        _close(dict(tm.named_parameters())[n].grad.numpy(), p.detach().numpy(), 1e-4, n)
    want_d = discriminator_from_jax(jax.device_get(jnew.d_opt_state.g), dv["batch_stats"],
                                    dtype=torch.float32, device="cpu")
    for n, p in want_d.named_parameters():
        _close(dict(td.named_parameters())[n].grad.numpy(), p.detach().numpy(), 1e-4, n)
    new_vq = jnew.vq["level_0"]
    for name in ("codebook", "cluster_size", "embed_avg"):
        _close(getattr(tm.vq, name).numpy(), getattr(new_vq, name), 1e-5, name)
    for n in (1, 2, 3):
        for k in ("mean", "var"):
            _close(getattr(getattr(td, f"norm_{n}"), k).numpy(),
                   jnew.d_batch_stats[f"norm_{n}"][k], 1e-4, f"norm_{n}.{k}")
    # Adam's first step from the port's gradients: −lr·m̂/(√v̂ + eps)
    for n, p in tm.named_parameters():
        g = p.grad.numpy().astype(np.float64)
        want = before[n].numpy() - SCHED["lr"] * g / (np.abs(g) + 1e-8)
        _close(p.detach().numpy(), want, 1e-6, n)

    _, ev = make_vqvae_eval_step(tm, loss_name="jukebox")(state, _ncdhw(x), SCHED)
    assert np.isfinite(float(ev["Loss"]))


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX, the JAX
    package or the repo-root JAX modules (the CLIs, bench.py, tools/,
    __graft_entry__.py)."""
    repo = Path(__file__).resolve().parents[1]
    banned = {"jax", "flax", "optax", "synthanatomy_tpu", "run_vqvae", "run_transformer",
              "bench", "tools", "__graft_entry__"}
    files = sorted((repo / "synthanatomy_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path.name} imports {name}"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is checked where there is no card")
    with pytest.raises((RuntimeError, AssertionError)):
        BaselineVQVAE(n_levels=1, downsample_parameters=DOWN, upsample_parameters=UP,
                      n_embed=4, embed_dim=2, n_channels=4, n_res_channels=4, n_res_layers=1)
    tm = BaselineVQVAE(n_levels=1, downsample_parameters=DOWN, upsample_parameters=UP,
                       n_embed=4, embed_dim=2, n_channels=4, n_res_channels=4, n_res_layers=1,
                       device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        create_vqvae_train_state(tm)
    with pytest.raises((RuntimeError, AssertionError)):
        tlpips.init_lpips_params("alex")


@pytest.mark.parametrize("module", [
    "ops/local_attention_splash.py", "models/performer.py", "interop.py",
    "tools/__init__.py", "tools/bench_transformer.py", "ops/fused_decode.py",
    "ops/favor.py", "ops/local_attention.py", "models/sampling.py", "ops/quant.py",
    "ops/probes.py", "tools/_probe_util.py", "tools/probe_int4.py",
    "tools/probe_int4_unpack.py", "tools/probe_pallas_overhead.py",
    "tools/bench_decode_quant.py",
])
def test_new_port_modules_import_no_jax(module):
    """The modules of the splash and exact-decode slices exist and import
    neither JAX nor the JAX package (the whole-package walk above covers
    them too)."""
    path = Path(__file__).resolve().parents[1] / "synthanatomy_tpu_torch" / module
    banned = {"jax", "flax", "optax", "synthanatomy_tpu"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not {n.split(".")[0] for n in names} & banned, f"{module} imports {names}"
