"""The port's device augmentation (``synthanatomy_tpu_torch/ops/augment.py``)
against JAX's ``synthanatomy_tpu/ops/augment.py`` on the same numpy
inputs, on the CPU:

- ``affine_resample`` against JAX's and scipy's ``affine_transform``
  (atol 2e-5, as ``tests/test_device_augment.py``; against JAX 1e-6);
- ``affine_resample_shear`` against JAX's with the same shifts (2e-5);
- ``shear_shift_bounds`` equal to JAX's tuple;
- ``augment_batch`` with both resamplers, noise off, against JAX's
  (1e-5: the gamma power may differ by an ulp);
- the noise term: its law N(0, noise_std²), its determinism given the
  sample's seed (the values differ from JAX's stream by design);
- the stage-1 runner trains with ``device_augmentation=True`` on the 3-pass
  route, as ``tests/test_device_augment.py`` checks for JAX.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage, stats

from synthanatomy_tpu.data.transforms import VQVAETransform as JTransform
from synthanatomy_tpu.data.transforms import _draw_affine
from synthanatomy_tpu.ops import augment as J
from synthanatomy_tpu_torch.data.transforms import VQVAETransform
from synthanatomy_tpu_torch.ops import augment as T

PAPER = (160, 224, 160)
# JAX's side jitted (its eager shift loops take seconds); the shifts static
_jshear = jax.jit(J.affine_resample_shear, static_argnums=3)
_jbatch = jax.jit(J.augment_batch, static_argnums=2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _affine(seed, shape, **ranges):
    M, off = _draw_affine(np.random.default_rng(seed), shape, shape, **ranges)
    return M.astype(np.float32), off.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_resample_matches_jax_and_scipy(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(12, 14, 10)).astype(np.float32)
    M, off = _affine(seed + 10, x.shape, rotate_range=0.3, translate_range=2.0,
                     scale_range=0.1)
    got = T.affine_resample(_t(x), M, off).numpy()
    want = ndimage.affine_transform(x, M.astype(np.float64), offset=off.astype(np.float64),
                                    output_shape=x.shape, order=1, mode="constant", cval=0.0)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(J.affine_resample(x, M, off)), rtol=0, atol=1e-6)


def test_affine_resample_identity_is_exact():
    """Integer sample coordinates: the floor must land on the voxel."""
    x = np.random.default_rng(3).uniform(size=(9, 7, 5)).astype(np.float32)
    got = T.affine_resample(_t(x), np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("shape,ranges", [
    ((24, 28, 20), dict(rotate_range=0.08, translate_range=2.0, scale_range=0.06)),
    ((32, 40, 28), dict(rotate_range=0.44, translate_range=4.0, scale_range=0.07)),
])
def test_affine_resample_shear_matches_jax(shape, ranges):
    shifts = J.shear_shift_bounds(shape, **ranges)
    x = np.random.default_rng(5).uniform(size=shape).astype(np.float32)
    for seed in range(3):
        M, off = _affine(seed, shape, **ranges)
        got = T.affine_resample_shear(_t(x), M, off, shifts).numpy()
        want = np.asarray(_jshear(x, M, off, shifts))
        # 2e-5: under jit XLA reorders the sum over the shifts (eagerly the
        # two agree bit for bit)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,ranges", [
    (PAPER, VQVAETransform(augment=True).affine_ranges()),
    ((32, 40, 28), dict(rotate_range=0.44, translate_range=4.0, scale_range=0.07)),
])
def test_shear_shift_bounds_equal_jax(shape, ranges):
    got = T.shear_shift_bounds(shape, **ranges)
    assert isinstance(got, tuple) and got == J.shear_shift_bounds(shape, **ranges)


def _params(shape, n, *, noise, seed=0, p=1.0):
    tf = JTransform(augment=True, augmentation_probability=p, augmentation_strength=2.0,
                    normalize=False)
    drawn = [tf.draw_device_params(shape, np.random.default_rng(seed + i))[0] for i in range(n)]
    params = {k: np.stack([d[k] for d in drawn]) for k in drawn[0]}
    if not noise:
        params["noise_fired"][:] = False
    return params, tf


@pytest.mark.parametrize("mode", ["exact", "shear"])
@pytest.mark.parametrize("p", [1.0, 0.5])
def test_augment_batch_matches_jax_without_noise(mode, p):
    shape = (20, 24, 16)
    params, tf = _params(shape, 3, noise=False, seed=11, p=p)
    shifts = T.shear_shift_bounds(shape, **tf.affine_ranges()) if mode == "shear" else None
    x = np.random.default_rng(4).uniform(size=(3,) + shape + (1,)).astype(np.float32)
    got = T.augment_batch(_t(x), params, shifts)
    want = np.asarray(_jbatch(x, params, shifts))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the channel-less layout gives the same volumes
    np.testing.assert_array_equal(T.augment_batch(_t(x[..., 0]), params, shifts).numpy(),
                                  got.numpy()[..., 0])


def test_params_as_tensors_give_the_same_batch():
    shape = (10, 12, 8)
    params, _ = _params(shape, 2, noise=True, seed=3)
    x = _t(np.random.default_rng(6).uniform(size=(2,) + shape).astype(np.float32))
    a = T.augment_batch(x, params)
    b = T.augment_batch(x, {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    assert torch.equal(a, b)


def test_noise_term_law_and_determinism():
    """Only the noise fires, on a constant 0.5 volume far from the clamp:
    out - 0.5 is the noise term, N(0, noise_std²) per sample; the same
    seed gives the same values, another seed other values."""
    shape = (24, 24, 24)
    params, _ = _params(shape, 4, noise=True, seed=20)
    for k in ("affine_fired", "contrast_fired", "shift_fired"):
        params[k][:] = False
    params["noise_std"][:] = np.float32(0.05)
    x = torch.full((4,) + shape, 0.5)
    out = T.augment_batch(x, params)
    noise = (out - 0.5).double().numpy()
    std = 0.05
    n = noise[0].size
    for b in range(4):
        s = noise[b].ravel()
        assert abs(s.mean()) < 4 * std / np.sqrt(n), s.mean()
        np.testing.assert_allclose(s.std(), std, rtol=0.02)
        assert stats.kstest(s / std, "norm").pvalue > 1e-3
    again = T.augment_batch(x, params)
    assert torch.equal(out, again)
    assert not torch.equal(out[0], out[1])


def test_runner_trains_with_device_augmentation(tmp_path, monkeypatch):
    """``run_vqvae`` training with ``device_augmentation=True`` takes the
    3-pass route (production ranges are under the 0.5 rad gate), applies
    ``augment_batch`` to every training batch and trains to a finite loss."""
    from synthanatomy_tpu_torch.data.nifti import save_nifti
    from synthanatomy_tpu_torch.run_vqvae import run

    picked, calls = [], []
    real_bounds, real_batch = T.shear_shift_bounds, T.augment_batch

    def bounds(shape, **kw):
        picked.append(real_bounds(shape, **kw))
        return picked[-1]

    def batch(x, params, shifts=None):
        calls.append((tuple(x.shape), shifts, sorted(params)))
        return real_batch(x, params, shifts)

    monkeypatch.setattr(T, "shear_shift_bounds", bounds)
    monkeypatch.setattr(T, "augment_batch", batch)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        save_nifti(str(data / f"s{i}.nii.gz"), rng.uniform(size=(24, 24, 24)).astype(np.float32))
    out = run(
        mode="training", training_subjects=str(data), validation_subjects=str(data),
        project_directory=str(tmp_path), experiment_name="devaug", epochs=1, batch_size=2,
        eval_batch_size=2, eval_every=1, checkpoint_every=1, num_workers=0, loss="mse",
        augmentation_probability=1.0, device_augmentation=True, no_levels=2,
        downsample_parameters=((4, 2, 1, 1), (4, 2, 1, 1)),
        upsample_parameters=((4, 2, 1, 0, 1), (4, 2, 1, 0, 1)), no_channels=8,
        no_res_layers=1, num_embeddings=(16,), embedding_dim=(4,), decay=(0.5,),
        gamma=0.999, compute_dtype="float32", use_pallas_vq=False, seed=7, device="cpu",
    )
    assert np.isfinite(out["history"][-1]["Loss-Reconstruction-Total"])
    assert picked == [J.shear_shift_bounds((24, 24, 24), **JTransform().affine_ranges())]
    assert len(calls) == 2  # 4 volumes at B2: one call a step
    assert all(c == ((2, 24, 24, 24, 1), picked[0], sorted(calls[0][2])) for c in calls)
    assert "matrix" in calls[0][2] and "noise_seed" in calls[0][2]


def test_runner_keeps_the_host_paths_layout():
    """The augmented batch reaches the model in the layout of the host
    path's batch (``_volumes``: a channels-last view), so that cuDNN meets
    one layout, and with the chain's values."""
    from synthanatomy_tpu_torch.runners import vqvae as runner

    shape = (10, 12, 8)
    params, _ = _params(shape, 2, noise=False, seed=9)
    batch = {"MRI": np.random.default_rng(2).uniform(size=(2,) + shape + (1,))
             .astype(np.float32), "augment": params}
    x = runner._volumes(batch, "cpu")
    y = runner._augmented(x, batch, None)
    assert y.shape == x.shape and y.stride() == x.stride()
    np.testing.assert_array_equal(y[:, 0].numpy(), T.augment_batch(x[:, 0], params).numpy())
