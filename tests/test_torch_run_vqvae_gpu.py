"""The port's stage-1 runner on the card at a small size: the training
step routes row 3 (``vq_argmin_kernel``) and row 7 (the fused residual
layer, forced on) to the kernels under ``--use_pallas_vq=True``, and
extraction with ``--use_pallas_vq=False`` picks the kernel's codes up to
near-ties.

Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_run_vqvae_gpu.py

Every test is marked ``gpu`` and skips without a CUDA card.
"""

import os

import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.data.nifti import save_nifti
from synthanatomy_tpu_torch.ops import res_stack as rs
from synthanatomy_tpu_torch.ops import vq
from synthanatomy_tpu_torch.run_vqvae import run

pytestmark = pytest.mark.gpu

FLAGS = dict(
    experiment_name="gpu", epochs=1, batch_size=2, eval_batch_size=2, checkpoint_every=1,
    num_workers=2, prefetch_factor=2, loss="mse", adversarial_component=True, no_levels=2,
    downsample_parameters=((4, 2, 1, 1),) * 2, upsample_parameters=((4, 2, 1, 0, 1),) * 2,
    no_channels=64, no_res_layers=1, num_embeddings=(256,), embedding_dim=(32,), decay=(0.5,),
    compute_dtype="bfloat16", device=0,
)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tmp_path_factory.mktemp("gpu_run")
    rng = np.random.default_rng(0)
    d = root / "data"
    d.mkdir()
    for i in range(4):
        save_nifti(str(d / f"s{i}.nii.gz"), rng.uniform(size=(48, 48, 48)).astype(np.float32))
    return root


def test_training_routes_rows_3_and_7_to_the_kernels(data, monkeypatch):
    # the fused layer's auto gate (remat training, the CLI's default) at
    # this size: every residual layer takes the kernel
    from synthanatomy_tpu_torch.models import vqvae as vqm

    monkeypatch.setattr(vqm, "_FUSED_MIN_VOXELS", 0)
    vq.nearest_codeword.launches = 0
    rs.fused_residual_layer.launches = rs.fused_residual_layer.bwd_launches = 0
    out = run(training_subjects=str(data / "data"), project_directory=str(data / "proj"),
              use_pallas_vq=True, **FLAGS)
    assert vq.nearest_codeword.launches == 2  # one a step
    assert rs.fused_residual_layer.launches > 0 and rs.fused_residual_layer.bwd_launches > 0
    assert all(np.isfinite(v) for v in out["history"][0].values())


def _latents(proj, data_dir):
    """Each extracted subject's f32 latents (d, h, w, C) and the codebook,
    from the checkpoint the runner trained."""
    from synthanatomy_tpu_torch.config import VQVAEConfig
    from synthanatomy_tpu_torch.runners import vqvae as runner
    from synthanatomy_tpu_torch.train import checkpoints as C

    cfg = VQVAEConfig(training_subjects=data_dir, project_directory=proj,
                      mode="extracting", **{k: v for k, v in FLAGS.items() if k != "device"})
    model = runner.build_vqvae(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = runner.create_vqvae_train_state(model, 0, device="cuda")
    ckdir = os.path.join(proj, "gpu", "baseline_vqvae", "checkpoints")
    C.load_checkpoint(os.path.join(ckdir, "checkpoint_epoch=1"), state, models_only=True)
    out = {}
    for batch in runner._make_loaders(cfg, "extracting")["train"].epoch(0):
        with torch.no_grad(), model.unfused():
            z = model.encode(runner._volumes(batch, "cuda"))[0].float()
        for b, src in enumerate(batch["paths"]):
            name = os.path.basename(src).replace(".nii.gz", "_quantization_0.npy")
            out[name] = z[b].permute(1, 2, 3, 0).double().cpu().numpy()
    return out, model.vq.codebook.double().cpu().numpy()


def test_plain_search_matches_the_kernel(data):
    proj = str(data / "proj")  # the checkpoint trained above
    written = {}
    for flag in (True, False):
        vq.nearest_codeword.launches = 0
        out = run(training_subjects=str(data / "data"), project_directory=proj,
                  mode="extracting", use_pallas_vq=flag, **FLAGS)
        assert (vq.nearest_codeword.launches > 0) == flag
        written[flag] = {os.path.basename(p): np.load(p) for p in out["written"]
                         if p.endswith("_quantization_0.npy")}
    assert sorted(written[True]) == sorted(written[False]) and written[True]
    latents, codebook = _latents(proj, str(data / "data"))
    total = diff = 0
    for name, a in written[True].items():
        b = written[False][name]
        total += a.size
        for pos in zip(*np.nonzero(a != b)):
            diff += 1
            # a mismatch is a near-tie: the two codes' distances from the
            # latent within 1e-4 relative of each other
            d = ((codebook - latents[name][pos]) ** 2).sum(1)
            da, db = d[a[pos]], d[b[pos]]
            assert abs(da - db) <= 1e-4 * max(da, db), (name, pos, da, db)
    assert diff <= 0.01 * total, (diff, total)
