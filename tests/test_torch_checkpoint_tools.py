"""The port's checkpoint tools (``synthanatomy_tpu_torch/tools/
{convert_checkpoint,convert_performer_checkpoint,convert_lpips,
export_checkpoint,import_checkpoint}.py``) on the CPU:

- each converter's ``.npz`` equals the JAX converter's on the same
  reference-layout ``.pt`` file, key for key and array for array (VQ-VAE
  with and without the sub-pixel up-sampler, discriminator, Performer
  pre-LayerNorm and ReZero with spatial and conditioning tables, LPIPS
  alex and squeeze), and the port reads each (``interop.*_from_jax``,
  ``load_lpips_npz``);
- round trips: a port checkpoint → ``export_checkpoint`` (reference
  ``.pt``) → ``convert_*`` (``.npz``) → ``import_checkpoint``
  (``checkpoint_epoch=0``) gives back every network tensor bit for bit,
  and exporting the ``.npz`` gives the same ``.pt`` as exporting the
  checkpoint;
- import → the port's CLIs: a JAX-made ``.npz`` imported, then decoded
  and extracted by ``run_vqvae`` (decoding within 1e-5 of JAX's
  ``decode_samples``) and sampled by ``run_transformer`` (the imported
  prior's logits within 1e-4 of JAX's), as ``tests/test_import_checkpoint.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu_torch import interop  # noqa: E402
from synthanatomy_tpu_torch.config import TransformerConfig, VQVAEConfig  # noqa: E402
from synthanatomy_tpu_torch.runners import transformer as prunner  # noqa: E402
from synthanatomy_tpu_torch.runners import vqvae as vrunner  # noqa: E402
from synthanatomy_tpu_torch.tools import convert_checkpoint as tconv  # noqa: E402
from synthanatomy_tpu_torch.tools import convert_lpips as tlpips  # noqa: E402
from synthanatomy_tpu_torch.tools import convert_performer_checkpoint as tperf  # noqa: E402
from synthanatomy_tpu_torch.tools import export_checkpoint as texport  # noqa: E402
from synthanatomy_tpu_torch.tools import import_checkpoint as timport  # noqa: E402
from synthanatomy_tpu_torch.train import checkpoints as TC  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VQ_NET = dict(no_levels=2, downsample_parameters=((4, 2, 1, 1), (4, 2, 1, 1)),
              upsample_parameters=((4, 2, 1, 0, 1), (4, 2, 1, 0, 1)), no_channels=8,
              no_res_layers=2, num_embeddings=(16,), embedding_dim=(4,),
              compute_dtype="float32", use_pallas_vq=False)
PRIOR_NET = dict(vocab_size=16, n_embd=32, n_layers=2, n_head=4, dim_head=8, nb_features=8,
                 local_attn_heads=2, local_window_size=8, ordering_type="raster_scan",
                 compute_dtype="float32", attn_compute_dtype="float32")
PRIOR_FORMS = {"pre-LayerNorm": dict(),
               "ReZero+spatial+conditioning": dict(use_rezero=True,
                                                   spatial_position_emb="absolute",
                                                   conditioning_num_tokens=(3, 5))}
GRID = (3, 3, 3)


def _randomize(module, seed):
    """Every parameter and buffer of ``module`` drawn normal (the ReZero
    gains and the EMA statistics too, so that none is left at its init)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return module


def _vqvae(seed=0, **kw):
    cfg = VQVAEConfig(**dict(VQ_NET, **kw))
    return _randomize(vrunner.build_vqvae(cfg, device="cpu",
                                          generator=torch.Generator().manual_seed(seed)), seed)


def _discriminator(seed=1):
    return _randomize(vrunner._build_discriminator(VQVAEConfig(), device="cpu"), seed)


def _prior(form, seed=2):
    cfg = TransformerConfig(**PRIOR_NET, **PRIOR_FORMS[form])
    model = prunner.build_performer(cfg, prunner.build_ordering(cfg, GRID), GRID, device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
    return _randomize(model, seed)


def _npz(path):
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def _same_npz(a, b):
    fa, fb = _npz(a), _npz(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    return fa


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    module.main()


@pytest.mark.parametrize("subpixel", [False, True])
def test_vqvae_converter_matches_jax(tmp_path, monkeypatch, subpixel):
    from tools import convert_checkpoint as jconv

    model = _vqvae(use_subpixel_conv=subpixel)
    pt = str(tmp_path / "ref.pt")
    torch.save(interop.export_vqvae_state_dict(model), pt)
    flags = ["--n_levels=2", "--n_res_layers=2"] + (["--use_subpixel_conv=1"] if subpixel else [])
    _run_jax(monkeypatch, jconv, ["vqvae", pt, str(tmp_path / "jax.npz")] + flags)
    tconv.main(["vqvae", pt, str(tmp_path / "port.npz")] + flags)
    flat = _same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")
    # the port reads the file back into the same network
    tree = tconv.unflatten_tree(flat)
    sd = interop.vqvae_state_dict_from_jax(tree["params"], tree["vq"], 2, 2)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_discriminator_converter_matches_jax(tmp_path, monkeypatch):
    from tools import convert_checkpoint as jconv

    model = _discriminator()
    pt = str(tmp_path / "ref.pt")
    torch.save(interop.export_discriminator_state_dict(model), pt)
    _run_jax(monkeypatch, jconv, ["discriminator", pt, str(tmp_path / "jax.npz")])
    tconv.main(["discriminator", pt, str(tmp_path / "port.npz")])
    tree = tconv.unflatten_tree(_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz"))
    back = interop.discriminator_from_jax(tree["params"], tree["batch_stats"], device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


@pytest.mark.parametrize("form", list(PRIOR_FORMS))
def test_performer_converter_matches_jax(tmp_path, monkeypatch, form):
    from tools import convert_performer_checkpoint as jperf

    model = _prior(form)
    pt = str(tmp_path / "ref.pt")
    torch.save(interop.export_performer_state_dict(model), pt)
    _run_jax(monkeypatch, jperf, [pt, str(tmp_path / "jax.npz"), "--depth=2"])
    tperf.main([pt, str(tmp_path / "port.npz"), "--depth=2"])
    tree = tconv.unflatten_tree(_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz"))
    sd = interop.performer_state_dict_from_jax(tree["params"], tree["favor"], 2)
    assert sorted(sd) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k].reshape(v.shape), v), k


def _alex_sd(rng):
    sd = {}
    for idx, (o, i, k) in zip((0, 3, 6, 8, 10), ((64, 3, 11), (192, 64, 5), (384, 192, 3),
                                                 (256, 384, 3), (256, 256, 3))):
        sd[f"features.{idx}.weight"] = rng.normal(size=(o, i, k, k)).astype(np.float32) * 0.05
        sd[f"features.{idx}.bias"] = rng.normal(size=(o,)).astype(np.float32) * 0.01
    return sd


def _squeeze_sd(rng):
    sd = {"features.0.weight": rng.normal(size=(64, 3, 3, 3)).astype(np.float32),
          "features.0.bias": rng.normal(size=64).astype(np.float32)}
    cin = 64
    for fi, (sq, ex) in zip((3, 4, 6, 7, 9, 10, 11, 12),
                            ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192),
                             (64, 256), (64, 256))):
        for part, shape in (("squeeze", (sq, cin, 1, 1)), ("expand1x1", (ex, sq, 1, 1)),
                            ("expand3x3", (ex, sq, 3, 3))):
            sd[f"features.{fi}.{part}.weight"] = rng.normal(size=shape).astype(np.float32)
            sd[f"features.{fi}.{part}.bias"] = rng.normal(size=shape[0]).astype(np.float32)
        cin = 2 * ex
    return sd


def _lin_sd(rng, chans, prefix="lin"):
    return {f"{prefix}{i}.model.1.weight": np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32)
            for i, c in enumerate(chans)}


@pytest.mark.parametrize("net", ["alex", "squeeze"])
def test_lpips_converter_matches_jax(tmp_path, monkeypatch, net):
    from synthanatomy_tpu_torch.losses.lpips import load_lpips_npz
    from tools import convert_lpips as jlpips

    rng = np.random.default_rng(0)
    if net == "alex":
        backbone, lin = _alex_sd(rng), _lin_sd(rng, (64, 192, 384, 256, 256))
    else:
        backbone, lin = _squeeze_sd(rng), _lin_sd(rng, (64, 128, 256, 384, 384, 512, 512),
                                                  prefix="lins.")
    paths = [str(tmp_path / "backbone.pth"), str(tmp_path / "lin.pth")]
    for p, sd in zip(paths, (backbone, lin)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, p)
    _run_jax(monkeypatch, jlpips, [net] + paths + [str(tmp_path / "jax.npz")])
    tlpips.main([net] + paths + [str(tmp_path / "port.npz")])
    _same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")
    params = load_lpips_npz(str(tmp_path / "port.npz"), device="cpu")
    assert params["kind"] == net


def _states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_vqvae_round_trip(tmp_path):
    """checkpoint → export → convert → import gives back G and its
    codebook bit for bit; D exports and converts back too."""
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state

    model, d_model = _vqvae(), _discriminator()
    state = create_vqvae_train_state(model, 0, d_model=d_model, device="cpu")
    ckpt = TC.save_checkpoint(str(tmp_path), state, 7)
    flags = [f"--{k}={v!r}" if isinstance(v, tuple) else f"--{k}={v}"
             for k, v in VQ_NET.items()]
    sd = texport.main(["vqvae", ckpt, str(tmp_path / "v.pt")] + flags)
    assert sd.keys() == interop.export_vqvae_state_dict(model).keys()
    tconv.main(["vqvae", str(tmp_path / "v.pt"), str(tmp_path / "v.npz"),
                "--n_levels=2", "--n_res_layers=2"])
    # the npz exports to the same reference file
    again = texport.main(["vqvae", str(tmp_path / "v.npz"), str(tmp_path / "v2.pt")] + flags)
    _states_equal(sd, again)
    path = timport.main(["vqvae", str(tmp_path / "v.npz"), f"--project_directory={tmp_path}",
                         "--experiment_name=back"] + flags)
    assert path.endswith(os.path.join("back", "baseline_vqvae", "checkpoints",
                                      "checkpoint_epoch=0"))
    _states_equal(torch.load(path, weights_only=True)["model"], model.state_dict())

    d_sd = texport.main(["discriminator", ckpt, str(tmp_path / "d.pt")] + flags)
    tconv.main(["discriminator", str(tmp_path / "d.pt"), str(tmp_path / "d.npz")])
    tree = tconv.load_npz_tree(str(tmp_path / "d.npz"))
    _states_equal(interop.discriminator_state_dict_from_jax(tree["params"], tree["batch_stats"]),
                  d_model.state_dict())
    assert d_sd.keys() == interop.export_discriminator_state_dict(d_model).keys()


@pytest.mark.parametrize("form", list(PRIOR_FORMS))
def test_performer_round_trip(tmp_path, form):
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    model = _prior(form)
    ckpt = TC.save_checkpoint(str(tmp_path), create_transformer_train_state(model, 0), 3)
    flags = [f"--{k}={v}" for k, v in PRIOR_NET.items()] + [f"--latent_shape={GRID!r}"]
    sd = texport.main(["performer", ckpt, str(tmp_path / "p.pt")] + flags)
    tperf.main([str(tmp_path / "p.pt"), str(tmp_path / "p.npz"), "--depth=2"])
    _states_equal(sd, texport.main(["performer", str(tmp_path / "p.npz"),
                                    str(tmp_path / "p2.pt")] + flags))
    path = timport.main(["performer", str(tmp_path / "p.npz"),
                         f"--project_directory={tmp_path}", "--experiment_name=back"] + flags)
    _states_equal(torch.load(path, weights_only=True)["model"], model.state_dict())


def test_export_refuses_a_checkpoint_without_a_discriminator(tmp_path):
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state

    ckpt = TC.save_checkpoint(str(tmp_path), create_vqvae_train_state(_vqvae(), device="cpu"), 1)
    with pytest.raises(SystemExit, match="no discriminator"):
        texport.export_model("discriminator", ckpt)


def test_import_refuses_a_mismatched_topology(tmp_path):
    model = _vqvae()
    torch.save(interop.export_vqvae_state_dict(model), tmp_path / "v.pt")
    tconv.main(["vqvae", str(tmp_path / "v.pt"), str(tmp_path / "v.npz"), "--n_levels=2",
                "--n_res_layers=2"])
    with pytest.raises(SystemExit, match="topology flags"):
        timport.import_vqvae(str(tmp_path / "v.npz"), project_directory=str(tmp_path),
                             experiment_name="bad", **dict(VQ_NET, no_channels=16))


def _jax_flat(tree):
    import jax

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat["/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)] = \
            np.asarray(leaf)
    return flat


def test_import_vqvae_then_the_cli_decodes_and_extracts(tmp_path):
    """A JAX-made npz → import → ``run_vqvae`` decoding (within 1e-5 of
    JAX's ``decode_samples`` on the same grid) and extraction."""
    import jax
    import jax.numpy as jnp

    from synthanatomy_tpu.config import VQVAEConfig as JConfig
    from synthanatomy_tpu.runners.vqvae import build_vqvae as jbuild
    from synthanatomy_tpu.train.vqvae_steps import create_vqvae_train_state as jstate
    from synthanatomy_tpu_torch.data.nifti import load_nifti, save_nifti
    from synthanatomy_tpu_torch.run_vqvae import run

    net = dict(VQ_NET, no_res_layers=1)
    jm = jbuild(JConfig(mode="decoding", adversarial_component=False, **net))
    state, _, _ = jstate(jm, jax.random.key(1), (12, 12, 12))
    npz = str(tmp_path / "vqvae.npz")
    np.savez(npz, **_jax_flat({"params": state.g_params, "vq": state.vq}))
    path = timport.import_vqvae(npz, project_directory=str(tmp_path), experiment_name="imp",
                                input_size=(12, 12, 12), **net)
    assert path.endswith("checkpoint_epoch=0")

    lat_dir = tmp_path / "latents"
    lat_dir.mkdir()
    lat = np.random.default_rng(0).integers(0, 16, (3, 3, 3)).astype(np.uint16)
    np.save(lat_dir / "s0_quantization_0.npy", lat)
    common = dict(project_directory=str(tmp_path), experiment_name="imp", batch_size=1,
                  num_workers=0, adversarial_component=False, device="cpu", **net)
    res = run(mode="decoding", training_subjects=str(lat_dir), **common)
    nii = [p for p in res["written"] if p.endswith("_sample.nii.gz")]
    decoded = load_nifti(nii[0], as_closest_canonical=False).data
    decode = jax.jit(lambda v, g: jm.apply(v, [g], method=jm.decode_samples))
    direct = np.asarray(decode({"params": state.g_params, "vq": state.vq},
                               jnp.asarray(lat[None], jnp.int32)))[0, ..., 0]
    np.testing.assert_allclose(decoded, direct, rtol=0, atol=1e-5)

    vol_dir = tmp_path / "volumes"
    vol_dir.mkdir()
    save_nifti(str(vol_dir / "v0.nii.gz"),
               np.random.default_rng(1).uniform(size=(24, 24, 24)).astype(np.float32))
    res = run(mode="extracting", training_subjects=str(vol_dir), **common)
    grid = np.load([p for p in res["written"] if p.endswith("_quantization_0.npy")][0])
    assert grid.dtype == np.uint16 and grid.shape == (6, 6, 6) and grid.max() < 16


def test_import_performer_then_the_cli_samples(tmp_path):
    """A JAX-made npz (ReZero, spatial tables, projections) → import →
    ``run_transformer --mode=inference`` samples; the imported form is
    read from the npz, and the prior's logits match JAX's within 1e-4."""
    import jax
    import jax.numpy as jnp

    from synthanatomy_tpu.config import TransformerConfig as JConfig
    from synthanatomy_tpu.runners import transformer as jrunner
    from synthanatomy_tpu_torch.run_transformer import run

    form = dict(use_rezero=True, spatial_position_emb="absolute")
    jcfg = JConfig(mode="inference", **PRIOR_NET, **form)
    jm = jrunner.build_performer(jcfg, jrunner.build_ordering(jcfg, GRID), GRID)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, 17, (1, 28)), jnp.int32)
    v = jm.init({"params": jax.random.key(0), "favor": jax.random.key(1)}, tokens)
    rng = np.random.default_rng(3)
    v = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.2, v)
    npz = str(tmp_path / "prior.npz")
    np.savez(npz, **_jax_flat({"params": v["params"], "favor": v["favor"]}))
    path = timport.import_performer(npz, project_directory=str(tmp_path),
                                    experiment_name="imp", latent_shape=GRID, **PRIOR_NET)

    cfg = TransformerConfig(**PRIOR_NET, **form)
    model = prunner.build_performer(cfg, prunner.build_ordering(cfg, GRID), GRID, device="cpu")
    model.load_state_dict(torch.load(path, weights_only=True)["model"])
    with torch.no_grad():
        got = model(torch.tensor(np.asarray(tokens)).long()).numpy()
    want = np.asarray(jm.apply(v, tokens))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    lat_dir = tmp_path / "latents"
    lat_dir.mkdir()
    for i in range(2):
        np.save(lat_dir / f"s{i}_quantization_0.npy",
                np.random.default_rng(i).integers(0, 16, GRID).astype(np.uint16))
    res = run(mode="inference", training_subjects=str(lat_dir), project_directory=str(tmp_path),
              experiment_name="imp", eval_batch_size=2, num_workers=0, temperature=1.0,
              top_k=8, device="cpu", **PRIOR_NET, **form)
    assert len(res["written"]) == 2
    for p in res["written"]:
        g = np.load(p)
        assert g.dtype == np.uint16 and g.shape == GRID and g.max() < 16
