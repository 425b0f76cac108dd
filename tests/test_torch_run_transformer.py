"""The port's stage-2 CLI (``synthanatomy_tpu_torch.run_transformer``)
against the JAX package's, at ``tests/test_end_to_end.py``'s tiny stage-2
flags (8³ latents, vocab 16, n_embd 16, 1 layer, 2 heads of 8, 8
features, 1 local head of window 8, hilbert ordering, fixed spatial
tables) in f32 (attention products too), with ``--device=cpu``, dropout 0
and no redraw inside the compared steps:

- training from the same initial weights (JAX's carried across by
  ``interop.performer_from_jax``; the train-state factory is patched
  here, in the test only): the first epoch's CE and eval CE within 1e-3
  relative of JAX's;
- sampling with JAX's trained weights in a port checkpoint: greedy
  ``*_sample.npy`` grids equal to JAX's, or diverging first at a near-tie
  of the two tokens' logits (within ``NEAR_TIE``), shown by a
  teacher-forced forward;
- ``export_performer_state_dict`` against JAX's for pre-LayerNorm and
  ReZero blocks, key for key, values within 1e-6;
- ``tools/synthesize`` (greedy) against ``--mode=inference`` followed by
  ``run_vqvae --mode=decoding``: the same grids, volumes within 1e-5;
- ``tools/smoke_pipeline`` runs its five stages on the CPU.

The JAX runner runs once for the module.  Also: the flag surface, resume,
the layouts one process cannot hold, and the card as the default."""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu_torch import interop  # noqa: E402
from synthanatomy_tpu_torch.config import TransformerConfig, VQVAEConfig  # noqa: E402
from synthanatomy_tpu_torch.data.nifti import load_nifti  # noqa: E402
from synthanatomy_tpu_torch.runners import transformer as trunner  # noqa: E402
from synthanatomy_tpu_torch.train import checkpoints as TC  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

GRID = (8, 8, 8)
FLAGS = dict(
    experiment_name="e2e",
    epochs=1,
    batch_size=2,
    eval_batch_size=2,
    eval_every=1,
    checkpoint_every=1,
    log_every=1,
    num_workers=2,
    vocab_size=16,
    n_embd=16,
    n_layers=1,
    n_head=2,
    dim_head=8,
    nb_features=8,
    local_attn_heads=1,
    local_window_size=8,
    ordering_type="hilbert",
    spatial_position_emb="fixed",
    gamma=0.999,
    compute_dtype="float32",
    attn_compute_dtype="float32",
)
TFLAGS = dict(FLAGS, device="cpu")
# greedy grids may part only where the two tokens' logits (teacher-forced,
# f32) lie this close
NEAR_TIE = 1e-4


def _config(**kw):
    return TransformerConfig(**{k: v for k, v in dict(TFLAGS, **kw).items()
                                if k in TransformerConfig.__dataclass_fields__})


def _port_from_jax(cfg, params, favor, shape=GRID):
    """JAX Performer variables → the port's Performer of ``cfg``."""
    return interop.performer_from_jax(
        params, favor, cfg.n_layers, heads=cfg.n_head, dim_head=cfg.dim_head,
        local_attn_heads=cfg.local_attn_heads, local_window_size=cfg.local_window_size,
        nb_features=cfg.nb_features, use_rezero=cfg.use_rezero, use_scalenorm=cfg.use_scalenorm,
        spatial_position_emb=cfg.spatial_position_emb, spatial_shape=shape,
        ordering=trunner.build_ordering(cfg, shape),
        conditioning_num_tokens=cfg.conditioning_num_tokens,
        conditioning_type=cfg.conditioning_type if cfg.conditioning_num_tokens else "none",
        tie_embed=cfg.tie_embed, qkv_bias=cfg.qkv_bias, attn_out_bias=cfg.attn_out_bias,
        dtype=torch.float32, attn_compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Latents, and JAX's runner trained (one epoch) and sampled greedily
    once."""
    import jax

    import run_transformer as jcli
    from synthanatomy_tpu.train import transformer_steps as jsteps

    root = tmp_path_factory.mktemp("run_transformer")
    lat = root / "latents"
    lat.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        np.save(lat / f"subj{i}_quantization_0.npy",
                rng.integers(0, 16, size=GRID).astype(np.uint16))

    init = {}
    build = jsteps.create_transformer_train_state

    def recording(*a, **k):
        out = build(*a, **k)
        init.setdefault("state", jax.device_get(out[0]))
        return out

    jsteps.create_transformer_train_state = recording
    try:
        jproj = str(root / "jax")
        jtrain = jcli.run(training_subjects=str(lat), validation_subjects=str(lat),
                          project_directory=jproj, **FLAGS)
    finally:
        jsteps.create_transformer_train_state = build
    jsample = jcli.run(training_subjects=str(lat), project_directory=jproj,
                       **dict(FLAGS, mode="inference", sample=False))
    return dict(root=root, latents=str(lat), init=init["state"], train=jtrain,
                sample=jsample)


def test_run_signature_matches_the_reference_cli():
    import run_transformer as jcli
    from synthanatomy_tpu_torch import run_transformer as tcli

    want = inspect.signature(jcli.run).parameters
    got = inspect.signature(tcli.run).parameters
    assert list(got) == list(want)
    assert {k: p.default for k, p in got.items()} == {k: p.default for k, p in want.items()}
    # the one difference: the device also takes "cpu"
    diff = [k for k in want if got[k].annotation != want[k].annotation]
    assert diff == ["device"] and "str" in str(got["device"].annotation)


def test_config_device_takes_cpu():
    from synthanatomy_tpu_torch.utils.general import run_device

    assert run_device(TransformerConfig(device="cpu")) == torch.device("cpu")
    assert TransformerConfig().device == 0


def test_training_history_matches_jax(runs, monkeypatch):
    s = runs["init"]
    build = trunner.create_transformer_train_state

    def from_jax(model, seed, **kw):
        state = build(model, seed, **kw)
        state.model.load_state_dict(_port_from_jax(_config(), s.params, s.favor).state_dict())
        return state

    monkeypatch.setattr(trunner, "create_transformer_train_state", from_jax)
    from synthanatomy_tpu_torch.run_transformer import run

    out = run(training_subjects=runs["latents"], validation_subjects=runs["latents"],
              project_directory=str(runs["root"] / "torch_train"), **TFLAGS)
    got, want = out["history"], runs["train"]["history"]
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0]) == {"Loss", "val_Loss"}
    for k, w in want[0].items():
        assert abs(got[0][k] - w) <= 1e-3 * abs(w), (k, got[0][k], w)
    names = sorted(n.split("=")[0] for n in os.listdir(out["dirs"]["checkpoint_directory"]))
    assert names == ["checkpoint_epoch", "checkpoint_key_metric", "model_state_dict_epoch"]
    assert names == sorted(n.split("=")[0]
                           for n in os.listdir(runs["train"]["dirs"]["checkpoint_directory"]))


def _port_checkpoint(runs, name):
    """JAX's trained state as the port's checkpoint_epoch=1 in a project
    of its own; returns (project, the port model)."""
    s = runs["train"]["state"]
    model = _port_from_jax(_config(), s.params, s.favor)
    proj = runs["root"] / name
    ckdir = proj / "e2e" / "performer" / "checkpoints"
    ckdir.mkdir(parents=True)
    TC.save_checkpoint(str(ckdir), trunner.create_transformer_train_state(model, 0), 1)
    return str(proj), model


def _first_divergence(model, ordering, a, b):
    """The first sequence position where grids a and b differ, and the
    gap between those two tokens' logits there, from a teacher-forced
    forward over a's tokens."""
    order = ordering.get_sequence_ordering()
    sa, sb = a.reshape(-1)[order], b.reshape(-1)[order]
    p = int(np.nonzero(sa != sb)[0][0])
    inputs, _ = trunner.prepare_batch(a[None].astype(np.int32), ordering, 16)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(inputs))[0, p].double()
    return p, abs(float(logits[int(sa[p])] - logits[int(sb[p])]))


def test_greedy_sampling_matches_jax(runs):
    from synthanatomy_tpu_torch.run_transformer import run

    proj, model = _port_checkpoint(runs, "torch_sample")
    out = run(training_subjects=runs["latents"], project_directory=proj,
              **dict(TFLAGS, mode="inference", sample=False))
    got = {os.path.basename(p): p for p in out["written"]}
    want = {os.path.basename(p): p for p in runs["sample"]["written"]}
    assert sorted(got) == sorted(want) and len(got) == 4
    ordering = trunner.build_ordering(_config(), GRID)
    for name in got:
        a, b = np.load(want[name]), np.load(got[name])
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape == GRID
        assert int(b.max()) < 16
        if not np.array_equal(a, b):
            p, gap = _first_divergence(model, ordering, a, b)
            assert gap <= NEAR_TIE, (name, p, gap)


def _jax_performer_variables(cfg, seed):
    """A JAX Performer of ``cfg`` with every leaf seeded normal."""
    import jax
    import jax.numpy as jnp

    from synthanatomy_tpu.config import TransformerConfig as JConfig
    from synthanatomy_tpu.runners import transformer as jrunner

    jcfg = JConfig(**{k: getattr(cfg, k) for k in JConfig.__dataclass_fields__
                      if k != "device"})
    shape = (2, 3, 4)
    jm = jrunner.build_performer(jcfg, jrunner.build_ordering(jcfg, shape), shape)
    conds = ([jnp.zeros((1,), jnp.int32) for _ in cfg.conditioning_num_tokens]
             if cfg.conditioning_num_tokens else None)
    keys = {"params": jax.random.key(0), "favor": jax.random.key(1), "dropout": jax.random.key(2)}
    v = jax.eval_shape(lambda: jm.init(keys, jnp.zeros((1, 8), jnp.int32), conds))
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), v)
    return v["params"], v["favor"], shape


@pytest.mark.parametrize("form", [
    dict(),
    dict(use_rezero=True, spatial_position_emb="absolute", conditioning_num_tokens=(3, 2)),
    dict(use_rezero=True, tie_embed=True, qkv_bias=True, attn_out_bias=True),
], ids=["pre-LayerNorm", "ReZero+spatial+conditioning", "ReZero+tied+biases"])
def test_export_matches_jax(form):
    from synthanatomy_tpu import interop as jinterop

    cfg = _config(**form)
    params, favor, shape = _jax_performer_variables(cfg, 3)
    want = jinterop.export_performer_state_dict(params, depth=cfg.n_layers, favor=favor)
    got = interop.export_performer_state_dict(_port_from_jax(cfg, params, favor, shape))
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.asarray(w).shape, k
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=k)


def test_scalenorm_export_raises_in_both():
    from synthanatomy_tpu import interop as jinterop

    cfg = _config(use_scalenorm=True)
    params, favor, shape = _jax_performer_variables(cfg, 4)
    # JAX's check looks for a missing norm; a ScaleNorm block has one, so
    # JAX fails on its missing LayerNorm scale
    with pytest.raises((NotImplementedError, KeyError)):
        jinterop.export_performer_state_dict(params, depth=cfg.n_layers, favor=favor)
    with pytest.raises(NotImplementedError, match="ScaleNorm"):
        interop.export_performer_state_dict(_port_from_jax(cfg, params, favor, shape))


def test_resume_continues_the_uninterrupted_run(runs, monkeypatch):
    """Two calls (1 epoch, then 2) end where one 2-epoch call ends, with a
    redraw every 3 steps across the break; the restored model gives the
    saved model's logits."""
    from synthanatomy_tpu_torch.run_transformer import run

    flags = dict(TFLAGS, training_subjects=runs["latents"], feature_redraw_interval=3)
    whole = run(project_directory=str(runs["root"] / "resume_whole"), **dict(flags, epochs=2))
    proj = str(runs["root"] / "resume")
    first = run(project_directory=proj, **flags)
    x = torch.from_numpy(trunner.prepare_batch(np.load(
        os.path.join(runs["latents"], "subj0_quantization_0.npy"))[None].astype(np.int32),
        first["ordering"], 16)[0])
    with torch.no_grad():
        saved = first["state"].model.eval()(x)
    restored = {}
    load = TC.load_checkpoint

    def recording(path, state, **kw):
        out = load(path, state, **kw)
        with torch.no_grad():
            restored["logits"] = state.model.eval()(x)
        restored["counter"] = state.steps_since_redraw
        return out

    monkeypatch.setattr(TC, "load_checkpoint", recording)
    second = run(project_directory=proj, **dict(flags, epochs=2))
    assert torch.equal(restored["logits"], saved) and restored["counter"] == 2
    assert len(second["history"]) == 1 and second["state"].step == whole["state"].step == 4
    assert second["state"].steps_since_redraw == whole["state"].steps_since_redraw == 1
    assert second["history"][0] == whole["history"][1]
    want = whole["state"].model.state_dict()
    for k, v in second["state"].model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert "checkpoint_epoch=2" in os.listdir(second["dirs"]["checkpoint_directory"])


@pytest.mark.parametrize("flags,error,match", [
    (dict(mesh_shape=(2,)), ValueError, "WORLD_SIZE"),
    (dict(mesh_shape=(2, 2)), ValueError, "WORLD_SIZE"),
    (dict(zero1=True, mesh_shape=(2,)), ValueError, "WORLD_SIZE"),
    (dict(sp_shards=2), ValueError, "must divide the device count"),
    (dict(pp_stages=2), ValueError, "must divide the device count"),
], ids=["mesh", "mesh-tp", "zero1", "sp", "pp"])
def test_unported_options_raise(tmp_path, flags, error, match):
    """A layout the job's ranks (one process here) cannot hold raises
    before any work: a data or (data, model) mesh of more ranks, sequence
    shards or pipeline stages that do not divide them (JAX's rule).  The
    DP runs: test_torch_run_dp.py; SP and TP: test_torch_run_sp_tp.py; PP:
    test_torch_run_pp.py."""
    from synthanatomy_tpu_torch.run_transformer import run

    with pytest.raises(error, match=match):
        run(training_subjects=str(tmp_path), project_directory=str(tmp_path),
            **dict(TFLAGS, **flags))


@pytest.mark.parametrize("mode", ["training", "inference"])
def test_the_card_is_the_default(tmp_path, monkeypatch, mode):
    from synthanatomy_tpu_torch.run_transformer import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        run(training_subjects=str(tmp_path), project_directory=str(tmp_path),
            **dict(TFLAGS, mode=mode, device=0))


VQ = dict(no_levels=2, downsample_parameters=((4, 2, 1, 1),) * 2,
          upsample_parameters=((4, 2, 1, 0, 1),) * 2, no_channels=8, no_res_layers=1,
          num_embeddings=(16,), embedding_dim=(4,), compute_dtype="float32")


def test_synthesize_matches_inference_then_decoding(runs):
    """One command from both experiments' checkpoints gives the grids of
    ``--mode=inference`` and the volumes of ``run_vqvae --mode=decoding``
    on them."""
    from synthanatomy_tpu_torch.run_transformer import run
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae
    from synthanatomy_tpu_torch.runners.vqvae import build_vqvae
    from synthanatomy_tpu_torch.tools import synthesize
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state

    proj, _ = _port_checkpoint(runs, "torch_synth")
    vqvae = build_vqvae(VQVAEConfig(**VQ), device="cpu", generator=torch.Generator().manual_seed(7))
    ckdir = os.path.join(proj, "e2e", "baseline_vqvae", "checkpoints")
    os.makedirs(ckdir)
    TC.save_checkpoint(ckdir, create_vqvae_train_state(vqvae, 0, device="cpu"), 1)

    sampled = run(training_subjects=runs["latents"], project_directory=proj,
                  **dict(TFLAGS, mode="inference", sample=False))["written"]
    decoded = run_vqvae(training_subjects=os.path.dirname(sampled[0]), project_directory=proj,
                        experiment_name="e2e", mode="decoding", adversarial_component=False,
                        device="cpu", num_workers=2, batch_size=2, **VQ)["written"]
    out_dir = os.path.join(proj, "synthesis")
    net = {k: v for k, v in FLAGS.items() if k in TransformerConfig.__dataclass_fields__
           and k not in ("experiment_name", "ordering_type", "epochs", "batch_size")}
    written = synthesize.run(project_directory=proj, experiment_name="e2e",
                             output_directory=out_dir, latent_shape=GRID, num_volumes=3,
                             batch_size=2, sample=False, ordering_type="hilbert", device="cpu",
                             **dict(net, **VQ))
    assert [os.path.basename(p) for p in written] == [f"synth_{i:04d}.nii.gz" for i in range(3)]
    # greedy and unconditioned: every sample is one grid
    grid = np.load(sampled[0])
    assert all(np.array_equal(np.load(p), grid) for p in sampled)
    want = load_nifti(decoded[0], as_closest_canonical=False).data
    for i, p in enumerate(written):
        lat = np.load(os.path.join(out_dir, f"synth_{i:04d}_latents.npy"))
        assert lat.dtype == np.uint16 and np.array_equal(lat, grid)
        got = load_nifti(p, as_closest_canonical=False).data
        assert got.shape == want.shape == (32, 32, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=p)


def test_synthesize_needs_conditioning_values_for_a_conditioned_prior(tmp_path):
    from synthanatomy_tpu_torch.runners.vqvae import build_vqvae
    from synthanatomy_tpu_torch.tools import synthesize
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state

    cfg = _config(conditioning_num_tokens=(2,))
    model = trunner.build_performer(cfg, trunner.build_ordering(cfg, GRID), GRID, device="cpu")
    for net, state in (("performer", trunner.create_transformer_train_state(model, 0)),
                       ("baseline_vqvae", create_vqvae_train_state(
                           build_vqvae(VQVAEConfig(**VQ), device="cpu"), 0, device="cpu"))):
        ckdir = tmp_path / "c" / net / "checkpoints"
        ckdir.mkdir(parents=True)
        TC.save_checkpoint(str(ckdir), state, 1)
    net = {k: v for k, v in FLAGS.items() if k in TransformerConfig.__dataclass_fields__
           and k not in ("experiment_name", "ordering_type", "epochs", "batch_size")}
    kw = dict(project_directory=str(tmp_path), experiment_name="c",
              output_directory=str(tmp_path / "out"), latent_shape=GRID, num_volumes=1,
              batch_size=1, ordering_type="hilbert", device="cpu", conditioning_num_tokens=(2,),
              **dict(net, **VQ))
    with pytest.raises(ValueError, match="conditioning_values"):
        synthesize.run(**kw)
    with pytest.raises(ValueError, match="has 2 entries"):
        synthesize.run(conditioning_values=(1, 0), **{k: v for k, v in kw.items()})
    written = synthesize.run(conditioning_values=(1,), **kw)
    assert len(written) == 1 and os.path.isfile(written[0])


def test_smoke_pipeline_runs_on_the_cpu(tmp_path, capsys):
    from synthanatomy_tpu_torch.tools import smoke_pipeline

    smoke_pipeline.main(["--device=cpu", f"--workdir={tmp_path / 'smoke'}"])
    assert "SMOKE OK" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "smoke" / "samples")) == smoke_pipeline.N_SUBJECTS
