"""The port's stage-1 CLI (``synthanatomy_tpu_torch.run_vqvae``) against
the JAX package's, at ``tests/test_end_to_end.py``'s tiny f32 flags
(32³ volumes, 2 levels, 8 channels, loss ``mse``, adversarial on) with
``--device=cpu``:

- training from the same initial G and D (JAX's carried across by
  ``interop``; the train-state factory is patched here, in the test only): the
  first epoch's history within 1e-3 relative of JAX's;
- extracting with JAX's trained weights in a port checkpoint: the
  indices equal at >= 99% of positions, every mismatch a near-tie, the
  reconstructions and D's maps within 1e-4;
- decoding JAX's latents within 1e-4;
- the same output names and dtypes in both runs.

The JAX runner runs once for the module.  Also: the port's ``run()``
has the top-level ``run_vqvae.run``'s flags and defaults, auto-resume
flips on a second call, the options not ported yet raise,
``--device_augmentation`` trains and leaves extraction alone, and
``use_pallas_vq=False`` picks the same codes as the default route."""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu.data.nifti import load_nifti as j_load_nifti  # noqa: E402
from synthanatomy_tpu_torch import interop  # noqa: E402
from synthanatomy_tpu_torch.data.nifti import load_nifti, save_nifti  # noqa: E402
from synthanatomy_tpu_torch.runners import vqvae as trunner  # noqa: E402
from synthanatomy_tpu_torch.train import checkpoints as TC  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DOWN = ((4, 2, 1, 1), (4, 2, 1, 1))
UP = ((4, 2, 1, 0, 1), (4, 2, 1, 0, 1))
FLAGS = dict(
    experiment_name="e2e",
    epochs=1,
    batch_size=2,
    eval_batch_size=2,
    eval_every=2,
    checkpoint_every=1,
    num_workers=2,
    prefetch_factor=2,
    loss="mse",
    adversarial_component=True,
    no_levels=2,
    downsample_parameters=DOWN,
    upsample_parameters=UP,
    no_channels=8,
    no_res_layers=1,
    num_embeddings=(16,),
    embedding_dim=(4,),
    decay=(0.5,),
    gamma=0.999,
    compute_dtype="float32",
    use_pallas_vq=False,
)
TFLAGS = dict(FLAGS, use_pallas_vq=True, device="cpu")


def _models_from_jax(g_params, vq, d_params, d_stats):
    model = interop.vqvae_from_jax(g_params, vq, 2, 1, downsample_parameters=DOWN,
                                   upsample_parameters=UP, dtype=torch.float32, device="cpu")
    d_model = interop.discriminator_from_jax(d_params, d_stats, dtype=torch.float32,
                                             device="cpu")
    return model, d_model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Data, and JAX's runner trained, extracted and decoded once."""
    import jax

    import run_vqvae as jcli
    from synthanatomy_tpu.train import vqvae_steps as jsteps

    root = tmp_path_factory.mktemp("run_vqvae")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        save_nifti(str(data / f"subj{i}.nii.gz"), rng.uniform(size=(32, 32, 32)).astype(np.float32))

    init = {}
    build = jsteps.create_vqvae_train_state

    def recording(*a, **k):
        out = build(*a, **k)
        init.setdefault("state", jax.device_get(out[0]))
        return out

    jsteps.create_vqvae_train_state = recording
    try:
        jproj = str(root / "jax")
        jtrain = jcli.run(training_subjects=str(data), project_directory=jproj, **FLAGS)
    finally:
        jsteps.create_vqvae_train_state = build
    jextract = jcli.run(training_subjects=str(data), project_directory=jproj,
                        **dict(FLAGS, mode="extracting"))
    lat = root / "jax_latents"
    lat.mkdir()
    for p in jextract["written"]:
        if p.endswith("_quantization_0.npy"):
            os.link(p, lat / os.path.basename(p))
    jdecode = jcli.run(training_subjects=str(lat), project_directory=jproj,
                       **dict(FLAGS, mode="decoding"))
    return dict(root=root, data=str(data), latents=str(lat), init=init["state"], train=jtrain,
                extract=jextract, decode=jdecode)


def test_run_signature_matches_the_reference_cli():
    import run_vqvae as jcli
    from synthanatomy_tpu_torch import run_vqvae as tcli

    want = inspect.signature(jcli.run).parameters
    got = inspect.signature(tcli.run).parameters
    assert list(got) == list(want)
    assert {k: p.default for k, p in got.items()} == {k: p.default for k, p in want.items()}


def test_training_history_matches_jax(runs, monkeypatch):
    s = runs["init"]
    build = trunner.create_vqvae_train_state

    def from_jax(model, seed, **kw):
        state = build(model, seed, **kw)
        tm, td = _models_from_jax(s.g_params, s.vq, s.d_params, s.d_batch_stats)
        state.model.load_state_dict(tm.state_dict())
        state.d_model.load_state_dict(td.state_dict())
        return state

    monkeypatch.setattr(trunner, "create_vqvae_train_state", from_jax)
    proj = str(runs["root"] / "torch_train")
    from synthanatomy_tpu_torch.run_vqvae import run

    out = run(training_subjects=runs["data"], project_directory=proj, **TFLAGS)
    got, want = out["history"][0], runs["train"]["history"][0]
    assert set(want) <= set(got)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-3 * max(abs(w), 1e-6), (k, got[k], w)
    ckpts = sorted(os.listdir(out["dirs"]["checkpoint_directory"]))
    assert ckpts == ["checkpoint_epoch=1", "model_state_dict_epoch=1.pt"]
    assert ckpts == sorted(os.listdir(runs["train"]["dirs"]["checkpoint_directory"]))

    # a second call auto-resumes from checkpoint_epoch=1 and trains epoch 2
    out2 = run(training_subjects=runs["data"], project_directory=proj, **dict(TFLAGS, epochs=2))
    assert len(out2["history"]) == 1 and out2["state"].step == 2 * out["state"].step
    assert "checkpoint_epoch=2" in os.listdir(out2["dirs"]["checkpoint_directory"])


def _port_checkpoint(runs, name):
    """JAX's trained state as the port's checkpoint_epoch=1."""
    s = runs["train"]["state"]
    model, d_model = _models_from_jax(s.g_params, s.vq, s.d_params, s.d_batch_stats)
    state = trunner.create_vqvae_train_state(model, 0, d_model=d_model, device="cpu")
    proj = runs["root"] / name
    ckdir = proj / "e2e" / "baseline_vqvae" / "checkpoints"
    ckdir.mkdir(parents=True)
    TC.save_checkpoint(str(ckdir), state, 1)
    return str(proj), model


def _by_name(paths):
    return {os.path.basename(p): p for p in paths}


def _same_outputs(tout, jout):
    t, j = _by_name(tout["written"]), _by_name(jout["written"])
    assert sorted(t) == sorted(j)
    return t, j


def test_extracting_matches_jax(runs):
    from synthanatomy_tpu_torch.run_vqvae import run

    proj, model = _port_checkpoint(runs, "torch_extract")
    out = run(training_subjects=runs["data"], project_directory=proj,
              **dict(TFLAGS, mode="extracting"))
    t, j = _same_outputs(out, runs["extract"])
    codebook = model.vq.codebook.numpy().astype(np.float64)
    n_idx = n_mismatch = 0
    for name in t:
        if name.endswith(".npy"):
            a, b = np.load(t[name]), np.load(j[name])
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if name.endswith("_quantization_0.npy"):
                n_idx += a.size
                for pos in zip(*np.nonzero(a != b)):
                    n_mismatch += 1
                    # a mismatch is a near-tie: both codes' distances from
                    # the latent within 1e-4 relative of each other
                    z = _latent(model, runs["data"], name, pos)
                    d = ((codebook - z) ** 2).sum(1)
                    da, db = d[a[pos]], d[b[pos]]
                    assert abs(da - db) <= 1e-4 * max(da, db), (name, pos, da, db)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
        elif name.endswith(".nii.gz"):
            a, b = load_nifti(t[name]), j_load_nifti(j[name])
            assert a.data.dtype == b.data.dtype and a.data.shape == (32, 32, 32)
            assert np.abs(a.data - b.data).max() <= 1e-4, name
            np.testing.assert_array_equal(a.affine, b.affine)
        else:
            assert open(t[name], "rb").read() == open(j[name], "rb").read(), name
    assert n_idx and n_mismatch <= 0.01 * n_idx


def _latent(model, data, name, pos):
    from synthanatomy_tpu_torch.data.datasets import VolumeDataset
    from synthanatomy_tpu_torch.data.transforms import VQVAETransform

    src = os.path.join(data, name.replace("_quantization_0.npy", ".nii.gz"))
    ds = VolumeDataset([{"MRI": src}], VQVAETransform(mode="extracting", augment=False),
                       seed=4, use_native=False)
    x = torch.from_numpy(ds.get(0)["MRI"][None]).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        z = model.encode(x)[0][0]
    return z[(slice(None),) + tuple(pos)].double().numpy()


def test_decoding_matches_jax(runs):
    from synthanatomy_tpu_torch.run_vqvae import run

    proj, _ = _port_checkpoint(runs, "torch_decode")
    out = run(training_subjects=runs["latents"], project_directory=proj,
              **dict(TFLAGS, mode="decoding"))
    t, j = _same_outputs(out, runs["decode"])
    for name in t:
        if name.endswith(".nii.gz"):
            a, b = load_nifti(t[name]), j_load_nifti(j[name])
            assert a.data.dtype == b.data.dtype and a.data.shape == (32, 32, 32)
            assert np.abs(a.data - b.data).max() <= 1e-4, name
        else:
            a, b = np.load(t[name]), np.load(j[name])
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("flags", [dict(mesh_shape=(2,)), dict(mesh_shape=(4,), zero1=True)],
                         ids=["flags1", "flags2"])
@pytest.mark.parametrize("mode", ["training", "extracting"])
def test_unported_options_raise(tmp_path, flags, mode):
    """A data mesh wider than the job's ranks (one process here) raises
    before any work; the DP runs themselves are in test_torch_run_dp.py."""
    from synthanatomy_tpu_torch.run_vqvae import run

    with pytest.raises(ValueError, match="WORLD_SIZE"):
        run(training_subjects=str(tmp_path), project_directory=str(tmp_path),
            **dict(TFLAGS, mode=mode, **flags))


def _recording_datasets(monkeypatch):
    """Records each VolumeDataset's ``device_augment`` as the runner builds it."""
    from synthanatomy_tpu_torch.data import datasets

    seen = []
    real = datasets.VolumeDataset

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self.device_augment)

    monkeypatch.setattr(datasets, "VolumeDataset", Recording)
    return seen


def test_device_augmentation_trains(runs, tmp_path, monkeypatch):
    """``--device_augmentation=True`` no longer raises: the training set
    ships the drawn parameters (the evaluators' sets do not), every step
    takes ``augment_batch`` and the run trains to finite losses."""
    from synthanatomy_tpu_torch.ops import augment
    from synthanatomy_tpu_torch.run_vqvae import run

    seen = _recording_datasets(monkeypatch)
    calls = []
    real = augment.augment_batch
    monkeypatch.setattr(augment, "augment_batch",
                        lambda x, p, s=None: calls.append(s) or real(x, p, s))
    out = run(training_subjects=runs["data"], validation_subjects=runs["data"],
              project_directory=str(tmp_path),
              **dict(TFLAGS, device_augmentation=True, augmentation_probability=1.0,
                     eval_every=1))
    assert seen == [True, False, False]  # train, val, train_eval
    assert len(calls) == out["state"].step == 2 and all(s is not None for s in calls)
    assert all(np.isfinite(v) for v in out["history"][0].values())


def test_extracting_ignores_device_augmentation(runs, monkeypatch):
    """Extraction takes host-final volumes whatever the flag, as JAX's
    runner does: the flag changes no output byte."""
    from synthanatomy_tpu_torch.run_vqvae import run

    seen = _recording_datasets(monkeypatch)
    proj, _ = _port_checkpoint(runs, "torch_extract_devaug")
    outs = [run(training_subjects=runs["data"], project_directory=proj,
                **dict(TFLAGS, mode="extracting", device_augmentation=flag,
                       no_augmented_extractions=1))
            for flag in (True, False)]
    assert seen == [False, False]
    a, b = _by_name(outs[0]["written"]), _by_name(outs[1]["written"])
    assert sorted(a) == sorted(b) and a
    for name in a:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a[name]), np.load(b[name]), err_msg=name)
        elif name.endswith(".nii.gz"):
            np.testing.assert_array_equal(load_nifti(a[name]).data, load_nifti(b[name]).data)


def test_one_device_mesh_is_accepted():
    from synthanatomy_tpu_torch.config import VQVAEConfig

    trunner._check_supported(VQVAEConfig(mesh_shape=(1,), zero1=True))


def test_the_card_is_the_default(tmp_path, monkeypatch):
    from synthanatomy_tpu_torch.run_vqvae import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        run(training_subjects=str(tmp_path), project_directory=str(tmp_path),
            **dict(TFLAGS, device=0))


@pytest.mark.parametrize("training", [False, True])
def test_use_pallas_vq_false_picks_the_same_codes(training):
    from synthanatomy_tpu_torch.config import VQVAEConfig

    cfg = dict(no_levels=2, downsample_parameters=DOWN, upsample_parameters=UP, no_channels=8,
               no_res_layers=1, num_embeddings=(16,), embedding_dim=(4,),
               compute_dtype="float32")
    x = torch.rand(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(1))
    out = []
    for flag in (True, False):
        model = trunner.build_vqvae(VQVAEConfig(use_pallas_vq=flag, **cfg), device="cpu",
                                    generator=torch.Generator().manual_seed(0))
        assert model.use_pallas_vq is (None if flag else False)
        with torch.no_grad():
            if training:
                enc = model.encode(x)
                out.append(model.quantize(enc, training=True)[2][0])
                out.append(model.vq.codebook.clone())
            else:
                out.append(model.index_quantize(x)[0])
    for a, b in zip(out[: len(out) // 2], out[len(out) // 2:]):
        assert torch.equal(a, b)


NEW_MODULES = [
    "config.py", "run_vqvae.py", "inferers.py", "interop.py", "runners/vqvae.py",
    "data/__init__.py", "data/nifti.py", "data/transforms.py", "data/datasets.py",
    "native/__init__.py", "metrics/__init__.py", "metrics/regression.py", "metrics/ssim.py",
    "metrics/classification.py", "train/schedulers.py", "train/logging.py",
    "train/checkpoints.py", "utils/__init__.py", "utils/general.py", "utils/profiling.py",
    "tools/bench.py", "run_transformer.py", "runners/transformer.py", "tools/synthesize.py",
    "tools/smoke_pipeline.py", "train/transformer_steps.py",
]


def _imports(path):
    import ast

    tree = ast.parse(path.read_text())
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for sub in node.body:
                for n in ast.walk(sub):
                    guarded.add(id(n))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in guarded


@pytest.mark.parametrize("module", NEW_MODULES)
def test_slice_modules_import_no_jax_pandas_or_tensorboardx(module):
    """Neither JAX nor the JAX package, and no pandas (the card's machine
    has none); tensorboardX only behind the TBLogger's guard."""
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "synthanatomy_tpu_torch" / module
    for name, guarded in _imports(path):
        assert name not in {"jax", "flax", "optax", "orbax", "synthanatomy_tpu", "pandas"}, \
            f"{module} imports {name}"
        if name == "tensorboardX":
            assert module == "train/logging.py" and guarded, f"{module} imports tensorboardX"


def test_finetune_gate_matches_jax():
    """The device-side gate: the same streak counts and the same sticky
    release as JAX's on one sequence of D losses."""
    import jax.numpy as jnp

    from synthanatomy_tpu.runners import vqvae as jrunner

    losses = [0.5, 0.2, 0.3, 0.25, 0.9, 0.21, 0.22, 0.23, 0.6, 0.1]
    tgate = trunner.make_finetune_gate(0.2, 0.3, 3)
    jgate = jrunner.make_finetune_gate(0.2, 0.3, 3)
    tc, tr = torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.bool)
    jc, jr = jnp.zeros((), jnp.int32), jnp.zeros((), jnp.bool_)
    seen = []
    for d in losses:
        tc, tr = tgate(tc, tr, torch.tensor(d))
        jc, jr = jgate(jc, jr, jnp.float32(d))
        assert (int(tc), bool(tr)) == (int(jc), bool(jr)), d
        seen.append(bool(tr))
    assert seen.index(True) == 3 and all(seen[3:])  # released, and it stays released


def test_frozen_generator_trains_only_the_discriminator(tmp_path, monkeypatch):
    """With the finetune gate never met, G and its codebook keep their
    initial values while D trains."""
    from synthanatomy_tpu_torch.run_vqvae import run

    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        save_nifti(str(data / f"s{i}.nii.gz"), rng.uniform(size=(32, 32, 32)).astype(np.float32))
    kept = {}
    build = trunner.create_vqvae_train_state

    def recording(model, seed, **kw):
        state = build(model, seed, **kw)
        kept["g"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        kept["d"] = {k: v.clone() for k, v in state.d_model.state_dict().items()}
        return state

    monkeypatch.setattr(trunner, "create_vqvae_train_state", recording)
    out = run(training_subjects=str(data), project_directory=str(tmp_path / "p"),
              **dict(TFLAGS, finetune_adversarial_component=(1e6, 2e6), finetune_patience=1))
    state = out["state"]
    assert state.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, kept["g"][k]), k
    assert any(not torch.equal(v, kept["d"][k]) for k, v in state.d_model.state_dict().items())


@pytest.mark.parametrize("mode", ["extracting", "decoding"])
def test_forward_only_modes_run_the_residual_layers_unfused(tmp_path, monkeypatch, mode):
    """Under the CLI's remat default the training model leaves the fused
    residual to its auto gate; extraction and decoding take every layer
    off the kernel (JAX's forward-only policy) and restore the flag."""
    from synthanatomy_tpu_torch.models import vqvae as tmodels
    from synthanatomy_tpu_torch.run_vqvae import run

    rng = np.random.default_rng(6)
    data, proj = tmp_path / "data", str(tmp_path / "p")
    data.mkdir()
    for i in range(2):
        save_nifti(str(data / f"s{i}.nii.gz"), rng.uniform(size=(32, 32, 32)).astype(np.float32))
    run(training_subjects=str(data), project_directory=proj, **TFLAGS)  # the checkpoint
    if mode == "decoding":
        data = tmp_path / "latents"
        data.mkdir()
        for i in range(2):
            np.save(data / f"s{i}_quantization_0.npy",
                    rng.integers(0, 16, size=(8, 8, 8)).astype(np.uint16))
    seen, built = [], []
    forward = tmodels.ResidualLayer.forward

    def recording(self, x, **kw):
        seen.append(self.use_fused)
        return forward(self, x, **kw)

    monkeypatch.setattr(tmodels.ResidualLayer, "forward", recording)
    build = trunner.build_vqvae

    def keep(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    monkeypatch.setattr(trunner, "build_vqvae", keep)
    run(training_subjects=str(data), project_directory=proj, **dict(TFLAGS, mode=mode))
    assert seen and not any(f is not False for f in seen)
    layers = [m for m in built[0].modules() if isinstance(m, tmodels.ResidualLayer)]
    assert layers and all(m.use_fused is None for m in layers)


def test_loaders_prefetch_per_worker(tmp_path):
    """``--prefetch_factor`` bounds the batches loaded ahead, per worker as
    DataLoader counts it."""
    from synthanatomy_tpu_torch.config import VQVAEConfig

    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        save_nifti(str(data / f"s{i}.nii.gz"), np.zeros((8, 8, 8), np.float32))
    cfg = VQVAEConfig(training_subjects=str(data), validation_subjects=str(data),
                      num_workers=3, prefetch_factor=2)
    loaders = trunner._make_loaders(cfg, "training")
    assert {k: v.prefetch for k, v in loaders.items()} == {"train": 6, "val": 6, "train_eval": 6}
