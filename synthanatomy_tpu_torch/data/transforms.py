"""Host-side volume transform chain (NumPy/SciPy).

The port's own copy of ``synthanatomy_tpu/data/transforms.py``; only
``quantise_image`` differs (the port's model in place of a flax apply).
The port and JAX draw the same affines and write the same traces from
the same seed.

Rebuild of the reference's MONAI pipeline
(src/utils/vqvae.py:183-371): load → [scale 0-1] → [ROI crop] →
[symmetric pad] → [random patch] → augmentations → clamp [0,1], with a
per-sample applied-transform trace (TraceTransformsd,
src/transforms/general/dictonary.py:10-43).  Augmentation-strength
scalers match ``AugmentationStrengthScalers`` (src/utils/vqvae.py:46-52).

Everything operates on (D, H, W) float32 arrays on host; the batch is
staged to device by the dataset layer.  Randomness is an explicit
``np.random.Generator`` per sample (deterministic given seed + index —
the reference's per-rank ``set_determinism`` equivalent).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

__all__ = [
    "scale_intensity",
    "center_spatial_crop",
    "spatial_crop",
    "spatial_pad",
    "rand_spatial_crop",
    "clamp01",
    "VQVAETransform",
    "convert_to_sequence",
    "add_bos",
    "quantise_image",
]

# src/utils/vqvae.py:46-52
AFFINE_ROTATE_SCALE = 0.2
AFFINE_TRANSLATE_SCALE = 1.0
AFFINE_SCALE_SCALE = 0.01
ADJUST_CONTRAST_GAMMA_SCALE = 0.01
SHIFT_INTENSITY_OFFSET_SCALE = 0.025
GAUSSIAN_NOISE_STD_SCALE = 0.01


def scale_intensity(x: np.ndarray, minv: float = 0.0, maxv: float = 1.0) -> np.ndarray:
    x = x.astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.full_like(x, minv)
    return (x - lo) / (hi - lo) * (maxv - minv) + minv


def center_spatial_crop(x: np.ndarray, roi_size: Sequence[int]) -> np.ndarray:
    slices = []
    for dim, size in zip(x.shape, roi_size):
        size = min(dim, size)
        start = (dim - size) // 2
        slices.append(slice(start, start + size))
    return x[tuple(slices)]


def spatial_crop(
    x: np.ndarray, roi_start: Sequence[int], roi_end: Sequence[int]
) -> np.ndarray:
    slices = [
        slice(max(0, s), min(dim, e))
        for dim, s, e in zip(x.shape, roi_start, roi_end)
    ]
    return x[tuple(slices)]


def spatial_pad(x: np.ndarray, spatial_size: Sequence[int]) -> np.ndarray:
    """Symmetric pad up to ``spatial_size`` (SpatialPadd,
    NumpyPadMode.SYMMETRIC)."""
    pads = []
    for dim, target in zip(x.shape, spatial_size):
        total = max(0, target - dim)
        pads.append((total // 2, total - total // 2))
    if any(p != (0, 0) for p in pads):
        x = np.pad(x, pads, mode="symmetric")
    return x


def rand_spatial_crop(
    x: np.ndarray, roi_size: Sequence[int], rng: np.random.Generator
) -> np.ndarray:
    slices = []
    for dim, size in zip(x.shape, roi_size):
        size = min(dim, size)
        start = int(rng.integers(0, dim - size + 1))
        slices.append(slice(start, start + size))
    return x[tuple(slices)]


def clamp01(x: np.ndarray) -> np.ndarray:
    # two ThresholdIntensityd calls (vqvae.py:357-359)
    return np.clip(x, 0.0, 1.0)


def _draw_affine(
    rng: np.random.Generator,
    in_shape: Sequence[int],
    out_shape: Sequence[int],
    *,
    rotate_range: float,
    translate_range: float,
    scale_range: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw the MONAI-RandAffined parameters and return the output→input
    voxel map ``(M, offset)`` — shared by the host (scipy) and device
    (ops/augment.py) resamplers so both consume the per-sample rng
    stream identically."""
    angles = rng.uniform(-rotate_range, rotate_range, 3)
    trans = rng.uniform(-translate_range, translate_range, 3)
    scales = 1.0 + rng.uniform(-scale_range, scale_range, 3)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [k for k in range(3) if k != axis]
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    R = rot(0, angles[0]) @ rot(1, angles[1]) @ rot(2, angles[2])
    M = R @ np.diag(scales)
    c_in = (np.asarray(in_shape) - 1) / 2.0
    c_out = (np.asarray(out_shape) - 1) / 2.0
    # map output voxel -> input voxel
    offset = c_in - M @ c_out - trans
    return M, offset


def _rand_affine(
    x: np.ndarray,
    rng: np.random.Generator,
    *,
    rotate_range: float,
    translate_range: float,
    scale_range: float,
    spatial_size: Optional[Sequence[int]],
) -> np.ndarray:
    """MONAI RandAffined equivalent: random small rotation (radians,
    per-axis), translation (voxels), isotropic-ish scale, zero padding."""
    out_shape = tuple(spatial_size) if spatial_size else x.shape
    M, offset = _draw_affine(
        rng, x.shape, out_shape,
        rotate_range=rotate_range, translate_range=translate_range,
        scale_range=scale_range,
    )
    return ndimage.affine_transform(
        x, M, offset=offset, output_shape=out_shape, order=1, mode="constant", cval=0.0,
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# stage-2 preprocessing transforms — the offline alternative to
# prepare_batch (reference src/transforms/: ConvertToSequenced, AddBOSd,
# QuantiseImaged dict transforms and their array versions)
# ---------------------------------------------------------------------------


def convert_to_sequence(grid: np.ndarray, ordering) -> np.ndarray:
    """Latent index grid (*dims) → 1D token sequence in ordering order
    (reference ConvertToSequence)."""
    flat = np.asarray(grid).reshape(-1)
    return flat[ordering.get_sequence_ordering()]


def add_bos(seq: np.ndarray, bos_token: int) -> np.ndarray:
    """Prepend the BOS token (reference AddBOS)."""
    seq = np.asarray(seq)
    return np.concatenate([np.full((1,), bos_token, seq.dtype), seq])


def quantise_image(volume: np.ndarray, model) -> np.ndarray:
    """Run the VQ-VAE's ``index_quantize`` inside the transform chain
    (reference QuantiseImage): (D, H, W[, 1]) volume → int32 latent
    index grid.  ``model`` is the port's ``BaselineVQVAE``, on its own
    device."""
    import torch

    v = np.asarray(volume, np.float32)
    if v.ndim == 4:
        v = v[..., 0]
    device = model.vq.codebook.device
    with torch.no_grad():
        idx = model.index_quantize(torch.from_numpy(v)[None, None].to(device))
    return idx[0][0].cpu().numpy()


class VQVAETransform:
    """The full stage-1 chain with per-sample trace.

    Call with a loaded (D, H, W) volume and a seed; returns
    ``(volume, trace)`` where trace maps transform names to whether the
    randomized transform fired — the TraceTransformsd artifact
    (src/handlers/vqvae.py:177-235 consumes it).
    """

    def __init__(
        self,
        *,
        mode: str = "training",
        normalize: bool = True,
        roi: Optional[tuple] = None,
        patch_size: Optional[Tuple[int, ...]] = None,
        augment: bool = True,
        augmentation_probability: float = 0.2,
        augmentation_strength: float = 0.0,
    ):
        self.mode = mode
        self.normalize = normalize
        self.roi = roi
        self.patch_size = patch_size
        self.augment = augment
        self.p = augmentation_probability
        self.strength = augmentation_strength

    def _roi_size(self):
        if self.roi is None:
            return None
        if isinstance(self.roi[0], int):
            return tuple(self.roi)
        return tuple(b - a for a, b in self.roi)

    def affine_ranges(self) -> Dict[str, float]:
        """RandAffined parameter ranges at this strength (the
        AugmentationStrengthScalers formulas, vqvae.py:46-52) — shared
        by the host path, the device param draw, and the static shift
        bound for the 3-pass device resampler."""
        s = self.strength
        return {
            "rotate_range": 0.04 + AFFINE_ROTATE_SCALE * s,
            "translate_range": 2 + int(round(AFFINE_TRANSLATE_SCALE * s)),
            "scale_range": 0.05 + AFFINE_SCALE_SCALE * s,
        }

    def supports_device_augment(self) -> bool:
        """The device path covers the full-volume chain (RandAffined +
        photometric ops).  The patch path's flips/rot90 are cheap host
        slices on small patches — no reason to move them."""
        return self.augment and not self.patch_size

    def draw_device_params(
        self, shape: Sequence[int], rng: np.random.Generator
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, bool]]:
        """Draw the augmentation decisions + parameters for the
        device-side chain (``ops/augment.py``), consuming the
        per-sample rng stream in the same order as ``__call__``'s
        augment branch so traces and determinism are unchanged.  The
        gaussian-noise VALUES are the one divergence: the device
        stream is seeded from one host draw instead of drawing the
        full array on host."""
        assert self.supports_device_augment()
        s = self.strength
        trace: Dict[str, bool] = {}
        out_shape = self._roi_size() or tuple(shape)

        affine_fired = bool(rng.random() < self.p)
        trace["RandAffined"] = affine_fired
        if affine_fired:
            M, offset = _draw_affine(rng, shape, out_shape, **self.affine_ranges())
        else:
            M, offset = np.eye(3), np.zeros(3)

        contrast_fired = bool(rng.random() < self.p)
        trace["RandAdjustContrastd"] = contrast_fired
        gamma = 1.0
        if contrast_fired:
            lo = 0.99 - ADJUST_CONTRAST_GAMMA_SCALE * s
            hi = 1.01 + ADJUST_CONTRAST_GAMMA_SCALE * s
            gamma = float(rng.uniform(lo, hi))

        shift_fired = bool(rng.random() < self.p)
        trace["RandShiftIntensityd"] = shift_fired
        shift = 0.0
        if shift_fired:
            shift = float(
                rng.uniform(0.0, 0.05 + SHIFT_INTENSITY_OFFSET_SCALE * s)
            )

        noise_fired = bool(rng.random() < self.p)
        trace["RandGaussianNoised"] = noise_fired
        noise_seed = int(rng.integers(0, 2**31 - 1)) if noise_fired else 0

        params = {
            "affine_fired": np.asarray(affine_fired),
            "matrix": np.asarray(M, np.float32),
            "offset": np.asarray(offset, np.float32),
            "contrast_fired": np.asarray(contrast_fired),
            "gamma": np.asarray(gamma, np.float32),
            "shift_fired": np.asarray(shift_fired),
            "shift": np.asarray(shift, np.float32),
            "noise_fired": np.asarray(noise_fired),
            "noise_std": np.asarray(
                0.02 + GAUSSIAN_NOISE_STD_SCALE * s, np.float32
            ),
            "noise_seed": np.asarray(noise_seed, np.uint32),
        }
        return params, trace

    def __call__(
        self,
        x: np.ndarray,
        rng: Optional[np.random.Generator] = None,
        *,
        pre_normalized: bool = False,
        defer_augment: bool = False,
    ) -> Tuple[np.ndarray, Dict[str, bool]]:
        """``defer_augment=True`` runs only the deterministic host part
        (normalize/crop/pad) and skips the augment branch AND the final
        clamp — the device chain (ops/augment.py) applies both from the
        params drawn by ``draw_device_params``."""
        rng = rng or np.random.default_rng(0)
        trace: Dict[str, bool] = {}
        x = np.asarray(x, np.float32)
        if x.ndim > 3:
            x = x.reshape(x.shape[:3])

        if self.normalize and not pre_normalized:
            x = scale_intensity(x)

        if self.roi is not None:
            if isinstance(self.roi[0], int):
                x = center_spatial_crop(x, self.roi)
            else:
                x = spatial_crop(x, [a for a, _ in self.roi], [b for _, b in self.roi])
            x = spatial_pad(x, self._roi_size())

        if defer_augment:
            return np.ascontiguousarray(x, np.float32), trace

        if self.patch_size:
            x = rand_spatial_crop(x, self.patch_size, rng)

        if self.augment:
            s = self.strength
            if self.patch_size:
                for axis in range(3):
                    fired = bool(rng.random() < self.p)
                    trace[f"RandFlipd_{axis}"] = fired
                    if fired:
                        x = np.flip(x, axis=axis)
                for name, axes in (
                    ("RandRotate90d_01", (0, 1)),
                    ("RandRotate90d_12", (1, 2)),
                    ("RandRotate90d_02", (0, 2)),
                ):
                    fired = bool(rng.random() < self.p)
                    trace[name] = fired
                    if fired:
                        x = np.rot90(x, k=int(rng.integers(1, 4)), axes=axes)
            else:
                fired = bool(rng.random() < self.p)
                trace["RandAffined"] = fired
                if fired:
                    x = _rand_affine(
                        x, rng,
                        spatial_size=self._roi_size(),
                        **self.affine_ranges(),
                    )

            fired = bool(rng.random() < self.p)
            trace["RandAdjustContrastd"] = fired
            if fired:
                lo = 0.99 - ADJUST_CONTRAST_GAMMA_SCALE * s
                hi = 1.01 + ADJUST_CONTRAST_GAMMA_SCALE * s
                gamma = float(rng.uniform(lo, hi))
                eps = 1e-7
                mn, rngv = x.min(), x.max() - x.min()
                x = ((x - mn) / max(rngv, eps)) ** gamma * max(rngv, eps) + mn

            fired = bool(rng.random() < self.p)
            trace["RandShiftIntensityd"] = fired
            if fired:
                off = float(
                    rng.uniform(0.0, 0.05 + SHIFT_INTENSITY_OFFSET_SCALE * s)
                )
                x = x + off

            fired = bool(rng.random() < self.p)
            trace["RandGaussianNoised"] = fired
            if fired:
                std = 0.02 + GAUSSIAN_NOISE_STD_SCALE * s
                x = x + rng.normal(0.0, std, x.shape).astype(np.float32)

        x = clamp01(np.ascontiguousarray(x, np.float32))
        return x, trace
