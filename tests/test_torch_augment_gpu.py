"""The device augmentation on the card at small sizes: ``augment_batch``
with both resamplers against the same function on the CPU (noise off;
tolerance 1e-5 away from the voxels whose sample position lies within
1e-5 of an integer, where the floor may flip), and the stage-1 runner
training with ``--device_augmentation=True`` on the card.

Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_augment_gpu.py

Every test is marked ``gpu`` and skips without a CUDA card.
"""

import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.data.nifti import save_nifti
from synthanatomy_tpu_torch.data.transforms import VQVAETransform
from synthanatomy_tpu_torch.ops import augment as A

pytestmark = pytest.mark.gpu

SHAPE = (40, 48, 36)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _near_integer(params, shifts, b):
    m = np.asarray(params["matrix"][b], np.float32)
    off = np.asarray(params["offset"][b], np.float32)
    rows = ([(m[r, 0], m[r, 1], m[r, 2], off[r]) for r in range(3)] if shifts is None
            else A._pass_coeffs(m, off))
    ii, jj, kk = A._grid(SHAPE, "cpu")
    near = torch.zeros(SHAPE, dtype=torch.bool)
    for a_i, a_j, a_k, c in rows:
        p = float(a_i) * ii + float(a_j) * jj + float(a_k) * kk + float(c)
        near |= (p - torch.round(p)).abs() <= 1e-5
    return near


@pytest.mark.parametrize("resampler", ["exact", "3-pass"])
def test_augment_batch_card_matches_cpu(card, resampler):
    tf = VQVAETransform(augment=True, augmentation_probability=1.0, augmentation_strength=2.0)
    drawn = [tf.draw_device_params(SHAPE, np.random.default_rng(i))[0] for i in range(3)]
    params = {k: np.stack([d[k] for d in drawn]) for k in drawn[0]}
    params["noise_fired"][:] = False
    shifts = A.shear_shift_bounds(SHAPE, **tf.affine_ranges()) if resampler == "3-pass" else None
    x = torch.rand((3,) + SHAPE + (1,), generator=torch.Generator().manual_seed(0))
    want = A.augment_batch(x, params, shifts)
    got = A.augment_batch(x.to(card), params, shifts)
    assert got.device == card and got.shape == want.shape
    diff = (got.cpu() - want).abs()[..., 0]
    near = torch.stack([_near_integer(params, shifts, b) for b in range(3)])
    assert float(diff[~near].max()) <= 1e-5


def test_noise_term_on_the_card(card):
    tf = VQVAETransform(augment=True, augmentation_probability=1.0)
    drawn = [tf.draw_device_params(SHAPE, np.random.default_rng(10 + i))[0] for i in range(2)]
    params = {k: np.stack([d[k] for d in drawn]) for k in drawn[0]}
    for k in ("affine_fired", "contrast_fired", "shift_fired"):
        params[k][:] = False
    term = (A.augment_batch(torch.full((2,) + SHAPE, 0.5, device=card), params) - 0.5).double()
    std = float(params["noise_std"][0])
    assert abs(float(term.mean())) < 5 * std / term[0].numel() ** 0.5
    assert abs(float(term.std()) / std - 1) < 0.02
    assert torch.equal(term, (A.augment_batch(torch.full((2,) + SHAPE, 0.5, device=card),
                                              params) - 0.5).double())


def test_runner_trains_with_device_augmentation_on_the_card(card, tmp_path, monkeypatch):
    from synthanatomy_tpu_torch.run_vqvae import run

    calls = []
    real = A.augment_batch
    monkeypatch.setattr(A, "augment_batch",
                        lambda x, p, s=None: calls.append(x.device) or real(x, p, s))
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        save_nifti(str(data / f"s{i}.nii.gz"), rng.uniform(size=(32, 32, 32)).astype(np.float32))
    out = run(mode="training", training_subjects=str(data), project_directory=str(tmp_path),
              experiment_name="gpu_aug", epochs=1, batch_size=2, num_workers=2, loss="mse",
              adversarial_component=False, augmentation_probability=1.0,
              device_augmentation=True, no_levels=2,
              downsample_parameters=((4, 2, 1, 1),) * 2,
              upsample_parameters=((4, 2, 1, 0, 1),) * 2, no_channels=16, no_res_layers=1,
              num_embeddings=(64,), embedding_dim=(8,), decay=(0.5,), device=0)
    assert len(calls) == 2 and all(d.type == "cuda" for d in calls)
    assert all(np.isfinite(v) for v in out["history"][0].values())
