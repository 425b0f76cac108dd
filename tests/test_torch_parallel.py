"""The port's data parallelism and ZeRO-1 on the CPU: two gloo ranks
(``tests/torch_dp_worker.py``, started once for the module by
``parallel.distributed.launch``) against the JAX package.

The weights come from JAX's inits and cross by ``interop``; each rank
takes its half of a seeded global batch (2 volumes or sequences a rank).

- Stage 1 (mse, f32): the 2-rank step equals JAX's one-device
  ``make_vqvae_train_step`` on the concatenated batch, first without D
  (``tests/test_parallel.py:39``'s check), then adversarial with the
  adaptive weight and ``SplitBatchNorm`` over [fake; real]: metrics
  (rtol 1e-5 on the loss, 1e-4 of the largest magnitude elsewhere),
  every G and D gradient (1e-4), the EMA codebook (rtol 1e-4, atol 1e-5),
  ``cluster_size``, ``embed_avg`` and D's running statistics (1e-4).
- The ranks end each step with bit-identical parameters, codebooks and
  batch statistics.
- The prior (f32, dropout 0): the 2-rank step equals JAX's
  ``make_transformer_train_step_dp`` on a 2-device CPU mesh (loss rtol
  1e-5, gradients 1e-4).
- ZeRO-1 Adam equals replicated Adam after 3 steps
  (``tests/test_parallel.py:193``); its checkpoint, written after the
  first step, is the one-device file: a 1-rank run resumes from it and
  its next two steps on the concatenated batches equal the DP run's.
- Every rank's FAVOR projections are equal after a redraw, with dropout
  drawn from per-rank generators.
- ``make_dp_sampler``, greedy and sampled, equals ``make_sampler`` on
  each rank's rows with the rank folded into the generator
  (``tests/test_fused_decode.py:394,424``).
"""

import copy
import os
import sys
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu.models.discriminator import BaselineDiscriminator as JDisc  # noqa: E402
from synthanatomy_tpu.models.performer import Performer as JPerformer  # noqa: E402
from synthanatomy_tpu.models.vqvae import BaselineVQVAE as JVQVAE  # noqa: E402
from synthanatomy_tpu.parallel.mesh import make_mesh  # noqa: E402
from synthanatomy_tpu.train import transformer_steps as jts  # noqa: E402
from synthanatomy_tpu.train import vqvae_steps as jvs  # noqa: E402
from synthanatomy_tpu_torch.interop import (  # noqa: E402
    discriminator_from_jax,
    performer_from_jax,
    vqvae_from_jax,
)
from synthanatomy_tpu_torch.parallel import distributed as D  # noqa: E402
from synthanatomy_tpu_torch.parallel.mesh import rank_layout  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
WORLD = 2
DOWN = ((4, 2, 1, 1),) * 2
UP = ((4, 2, 1, 0, 1),) * 2
SCHED = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25, "gdl_factor": 0.0,
         "epoch": 0}
PRIOR = dict(heads=4, dim_head=8, local_attn_heads=2, local_window_size=6, nb_features=16,
             scan_chunk=8)
L, VOCAB = 24, 17


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (name, err, np.abs(want).max())


class _Capture(NamedTuple):
    hyperparams: dict
    g: Any


def _capture_tx():
    """An optax transformation that changes nothing and keeps the last
    gradients in its state, so the JAX step hands them back."""
    import optax

    def init(p):
        return _Capture({"learning_rate": jnp.zeros(())}, jax.tree.map(jnp.zeros_like, p))

    def update(g, s, p=None):
        return jax.tree.map(jnp.zeros_like, g), _Capture(s.hyperparams, g)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's models, weights, batches and reference steps."""
    jm = JVQVAE(n_levels=2, downsample_parameters=DOWN, upsample_parameters=UP, n_embed=16,
                embed_dim=4, n_channels=8, n_res_channels=8, n_res_layers=1, dtype=jnp.float32)
    gv = jax.device_get(jax.jit(jm.init)(jax.random.key(1), jnp.zeros((1, 8, 8, 8, 1))))
    x = np.random.default_rng(7).uniform(size=(2 * WORLD, 24, 24, 24, 1)).astype(np.float32)
    jd = JDisc(ndf=4, dtype=jnp.float32, use_split_bn=True)
    dv = jax.device_get(jax.jit(lambda k, xx: jd.init(k, xx, training=True))(
        jax.random.key(8), x[:2]))
    cap = _capture_tx()
    sched = {k: jnp.asarray(v) for k, v in SCHED.items()}
    ref = {}
    for adv in (False, True):
        st = jvs.VQVAETrainState(
            step=jnp.zeros((), jnp.int32), g_params=gv["params"],
            g_opt_state=cap.init(gv["params"]), vq=gv["vq"], rng=jax.random.key(0),
            d_params=dv["params"] if adv else None,
            d_batch_stats=dv["batch_stats"] if adv else None,
            d_opt_state=cap.init(dv["params"]) if adv else None)
        kw = dict(d_model=jd, d_tx=cap, use_adaptive_weight=True, d_grouped_stats=True) \
            if adv else {}
        ref["adv" if adv else "mse"] = jax.device_get(
            jax.jit(jvs.make_vqvae_train_step(jm, cap, loss_name="mse", **kw))(
                st, jnp.asarray(x), sched))

    pm = JPerformer(num_tokens=VOCAB, max_seq_len=L, dim=32, depth=2, dtype=jnp.float32,
                    attn_compute_dtype=jnp.float32, use_pallas_local=True,
                    use_pallas_favor=True, **PRIOR)
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, VOCAB - 1, size=(2 * WORLD, L + 1)).astype(np.int32)
            for _ in range(3)]
    pv = jax.device_get(jax.jit(pm.init)({"params": jax.random.key(0),
                                          "favor": jax.random.key(1)}, toks[0][:, :-1]))
    pstate = jts.TransformerTrainState(step=jnp.zeros((), jnp.int32), params=pv["params"],
                                       favor=pv["favor"], opt_state=cap.init(pv["params"]),
                                       rng=jax.random.key(2))
    mesh = make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    step = jax.jit(jts.make_transformer_train_step_dp(pm, cap, mesh))
    ref["prior"] = jax.device_get(step(pstate, jnp.asarray(toks[0][:, :-1]),
                                       jnp.asarray(toks[0][:, 1:]), None, {"lr": 1e-3}))
    return dict(gv=gv, dv=dv, x=x, pv=pv, toks=toks, ref=ref)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The two ranks' results (see ``tests/torch_dp_worker.py``)."""
    js = jax_side
    g = vqvae_from_jax(js["gv"]["params"], js["gv"]["vq"], 2, 1, downsample_parameters=DOWN,
                       upsample_parameters=UP, dtype=torch.float32, device="cpu")
    d = discriminator_from_jax(js["dv"]["params"], js["dv"]["batch_stats"], dtype=torch.float32,
                               use_split_bn=True, device="cpu")
    prior = performer_from_jax(js["pv"]["params"], js["pv"]["favor"], 2, device="cpu",
                               dtype=torch.float32, attn_compute_dtype=torch.float32,
                               use_pallas_local=True, use_pallas_favor=True, **PRIOR)
    toks = [torch.from_numpy(t).long() for t in js["toks"]]
    conds = [torch.tensor([0, 1, 2, 1], dtype=torch.int32)]
    spec = dict(
        g_model=g, d_model=d, prior=prior, x=_ncdhw(js["x"]),
        inputs=toks[0][:, :-1], targets=toks[0][:, 1:],
        step_inputs=[t[:, :-1] for t in toks], step_targets=[t[:, 1:] for t in toks],
        redraw_kwargs=dict(num_tokens=VOCAB, max_seq_len=L, dim=32, depth=2,
                           feature_redraw_interval=1, attn_dropout=0.1, ff_dropout=0.1,
                           dtype=torch.float32, **PRIOR),
        c_kwargs=dict(num_tokens=9, max_seq_len=12, dim=32, depth=2, heads=2, dim_head=16,
                      local_attn_heads=1, local_window_size=4, nb_features=16,
                      conditioning_num_tokens=(3,), conditioning_type="bos_replacement"),
        grid=(2, 3, 2), conds=conds,
    )
    out = tmp_path_factory.mktemp("dp_steps")
    torch.save(spec, out / "spec.pt")
    D.launch([sys.executable, WORKER, "steps", str(out / "spec.pt"), str(out)], WORLD,
             timeout=300)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], spec, out


def _jax_grads(tree, model_from):
    """JAX's gradient tree as the port's named parameters."""
    return dict(model_from(tree).named_parameters())


@pytest.mark.parametrize("case", ["mse", "adv"])
def test_stage1_dp_step_matches_jax_on_the_concatenated_batch(jax_side, ranks, case):
    js, (outs, _, _) = jax_side, ranks
    jnew, jmet = js["ref"][case]
    got = outs[0][case]
    for k, v in jmet.items():
        tol = 1e-5 if k.startswith("Loss-MSE") or k == "Loss-Reconstruction-Total" else 1e-4
        _close(got["metrics"][k], float(v), tol, k)
    want_g = _jax_grads(jnew.g_opt_state.g, lambda t: vqvae_from_jax(
        t, js["gv"]["vq"], 2, 1, downsample_parameters=DOWN, upsample_parameters=UP,
        dtype=torch.float32, device="cpu"))
    assert set(got["g_grads"]) == set(want_g)
    for n, p in want_g.items():
        _close(got["g_grads"][n].numpy(), p.detach().numpy(), 1e-4, n)
    new_vq = jnew.vq["level_0"]
    np.testing.assert_allclose(got["g"]["vq.codebook"].numpy(), new_vq.codebook,
                               rtol=1e-4, atol=1e-5)
    for name in ("cluster_size", "embed_avg"):
        _close(got["g"][f"vq.{name}"].numpy(), getattr(new_vq, name), 1e-5, name)
    if case == "adv":
        want_d = _jax_grads(jnew.d_opt_state.g, lambda t: discriminator_from_jax(
            t, js["dv"]["batch_stats"], dtype=torch.float32, use_split_bn=True, device="cpu"))
        for n, p in want_d.items():
            _close(got["d_grads"][n].numpy(), p.detach().numpy(), 1e-4, n)
        for n in (1, 2, 3):
            for k in ("mean", "var"):
                _close(got["d"][f"norm_{n}.{k}"].numpy(), jnew.d_batch_stats[f"norm_{n}"][k],
                       1e-4, f"norm_{n}.{k}")
        assert got["metrics"]["Adversarial-Weight"] != 1.0  # the adaptive weight ran


def test_ranks_end_each_step_bit_identical(ranks):
    outs, _, _ = ranks
    for case, keys in (("mse", ("g",)), ("adv", ("g", "d")), ("prior", ("params",))):
        for key in keys:
            a, b = outs[0][case][key], outs[1][case][key]
            assert set(a) == set(b)
            for n in a:
                assert torch.equal(a[n], b[n]), (case, n)
        assert outs[0][case]["metrics"] == outs[1][case]["metrics"], case


def test_prior_dp_step_matches_jax_dp_step(jax_side, ranks):
    js, (outs, _, _) = jax_side, ranks
    jnew, jmet = js["ref"]["prior"]
    got = outs[0]["prior"]
    _close(got["metrics"]["Loss"], float(jmet["Loss"]), 1e-5, "Loss")
    want = _jax_grads(jnew.opt_state.g, lambda t: performer_from_jax(
        t, js["pv"]["favor"], 2, device="cpu", dtype=torch.float32,
        attn_compute_dtype=torch.float32, **PRIOR))
    for n, p in want.items():
        _close(got["grads"][n].numpy(), p.detach().numpy(), 1e-4, n)


def test_zero1_adam_matches_replicated_adam(ranks):
    outs, _, _ = ranks
    for out in outs:
        for i, (z, r) in enumerate(zip(out["adam"]["zero1"], out["adam"]["replicated"])):
            for n in r:
                torch.testing.assert_close(z[n], r[n], rtol=1e-6, atol=1e-7,
                                           msg=f"step {i + 1}: {n}")
        for n, v in out["zero1_resumed"].items():
            assert torch.equal(v, out["adam"]["zero1"][-1][n]), n


def test_dp_zero1_checkpoint_resumes_on_one_rank(ranks):
    """The file written by rank 0 after ZeRO-1's first step loads into a
    one-device state (every parameter's Adam moments, gathered from both
    ranks) and the next two steps on the concatenated batches give the
    DP run's parameters."""
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step,
    )

    outs, spec, out = ranks
    model = copy.deepcopy(spec["prior"])
    state = create_transformer_train_state(model, 0, learning_rate=1e-3)
    C.load_checkpoint(str(out / "checkpoint_epoch=1"), state)
    assert state.step == 1
    assert len(state.optimizer.state) == len(list(model.parameters()))
    for n, v in model.state_dict().items():
        assert torch.equal(v, outs[0]["adam"]["zero1"][0][n]), n
    step = make_transformer_train_step(model)
    for x, y in list(zip(spec["step_inputs"], spec["step_targets"]))[1:]:
        state, _ = step(state, x, y, None, {"lr": 1e-3})
    for n, v in model.state_dict().items():
        torch.testing.assert_close(v, outs[0]["adam"]["zero1"][-1][n], rtol=1e-5, atol=1e-6,
                                   msg=n)


def test_a_flag_set_on_one_rank_reaches_every_rank(ranks):
    """The preemption flag the runners agree on at each epoch's end."""
    outs, _, _ = ranks
    assert [out["any_rank"] for out in outs] == [[True, False]] * WORLD
    assert D.any_rank(True, None, "cpu") is True


def test_favor_projections_stay_equal_over_ranks_after_a_redraw(ranks):
    outs, _, _ = ranks
    a, b = outs[0]["redraw"], outs[1]["redraw"]
    assert a["after"] and set(a["after"]) == set(b["after"])
    for n in a["after"]:
        assert torch.equal(a["after"][n], b["after"][n]), n
        assert not torch.equal(a["after"][n], a["before"][n]), n
    assert a["dropout_seed"] != b["dropout_seed"]  # dropout streams are the rank's own


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_dp_sampler_matches_per_rank_make_sampler(ranks, mode):
    outs, spec, _ = ranks
    grids = outs[0]["sampler"][mode]["dp"]
    assert outs[1]["sampler"][mode]["dp"] is None  # rank 0 gathers
    assert tuple(grids.shape) == (4,) + spec["grid"]
    for r in range(WORLD):
        np.testing.assert_array_equal(grids[2 * r:2 * (r + 1)].numpy(),
                                      outs[r]["sampler"][mode]["solo"].numpy())


def test_dp_sampler_needs_a_batch_that_divides(monkeypatch):
    from synthanatomy_tpu_torch.models import sampling
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer

    model = Performer(num_tokens=9, max_seq_len=12, dim=32, depth=1, heads=2, dim_head=16,
                      nb_features=16, device="cpu")
    monkeypatch.setattr(sampling, "group_info", lambda group: (0, 2))  # a group of 2 ranks
    with pytest.raises(ValueError, match="divide"):
        sampling.make_dp_sampler(model, Ordering("raster_scan", 3, (2, 3, 2)), global_batch=3,
                                 process_group=object())


@pytest.mark.parametrize("mesh,world,layout", [
    (None, 3, ((3, 1), None)), ((2,), 2, ((2, 1), None)), ((1,), 1, ((1, 1), None)),
    ((2, 1), 2, ((2, 1), None)), ((2,), 1, None), ((4,), 2, None), ((1, 2), 1, None),
    ((2, 2), 4, ((2, 2), "model")),
])
def test_check_data_mesh(mesh, world, layout):
    """``--mesh_shape`` must name the job's ranks: (N,) and (N, 1) are
    data parallelism, (d, m) the (data, model) layout of tensor
    parallelism (``parallel/mesh.rank_layout``, which took over the
    data-mesh check when TP was ported)."""
    if layout is None:
        with pytest.raises(ValueError, match="WORLD_SIZE"):
            rank_layout(mesh, world)
    else:
        got = rank_layout(mesh, world)
        assert (got.shape, got.inner) == layout


def test_fold_in_gives_each_rank_its_own_stream():
    draws = [torch.rand(4, generator=D.fold_in(torch.Generator().manual_seed(5), r))
             for r in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[1])
    assert D.fold_in(None, 1) is None


def test_launch_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match="exited with code 3"):
        D.launch([sys.executable, "-c",
                  "import os, sys, time; r = int(os.environ['RANK']); "
                  "sys.exit(3) if r == 1 else time.sleep(30)"], 2, timeout=60)


def test_single_process_sets_nothing_up(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert D.maybe_initialize_distributed("cpu") is False
    assert D.default_group() is None and D.group_info(None) == (0, 1)


def test_nccl_without_a_card_raises(monkeypatch):
    """A CUDA run never falls back to gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var, val in (("RANK", "0"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(var, val)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        D.maybe_initialize_distributed(0)
    assert not torch.distributed.is_initialized()


def test_only_rank_0_traces(tmp_path):
    from synthanatomy_tpu_torch.utils.profiling import StepProfiler

    assert StepProfiler(str(tmp_path)).dir == str(tmp_path)
    assert StepProfiler(str(tmp_path), rank=1).dir is None
