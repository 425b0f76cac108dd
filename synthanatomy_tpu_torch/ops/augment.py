"""Device-side volume augmentation.

Port of ``synthanatomy_tpu/ops/augment.py``: the randomized part of the
stage-1 transform chain (the reference's MONAI pipeline,
src/utils/vqvae.py:183-371) applied on the tensors' device from
parameters the host drew (``data/transforms.VQVAETransform
.draw_device_params``, which consumes the per-sample rng stream as the
host chain does, so traces and determinism are unchanged):

- the random affine, order-1 and zero outside, as
  ``scipy.ndimage.affine_transform(x, M, offset, order=1,
  mode="constant")``: :func:`affine_resample` (the exact trilinear gather)
  or :func:`affine_resample_shear` (three single-axis passes, the TPU's
  workaround for its missing vector gather, kept for parity with the
  reference's resampler rule);
- gamma contrast, intensity shift, gaussian noise, clamp to [0, 1].

No hand-written kernel: JAX writes this module in XLA gathers and
elementwise work, outside Pallas, and the port in PyTorch tensor ops.
The coordinates are formed in JAX's order of f32 operations, so that
``floor`` lands on the same integer.

Where JAX computes every transform and selects it by its fire flag, the
port reads the flags on the host (they come from the loader as numpy)
and skips what did not fire: the same values, fewer launches.  The
noise is the one deliberate difference: each sample's ``noise_seed``
seeds a ``torch.Generator`` on the batch's device, so the values differ
from JAX's ``jax.random.normal`` stream (and between the CPU and the
card); their law, N(0, noise_std²), is the same.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "affine_resample",
    "affine_resample_shear",
    "shear_shift_bounds",
    "augment_batch",
    "make_augment_fn",
]


def _grid(shape, device):
    """f32 index vectors broadcast along each axis of a (D, H, W) volume."""
    d, h, w = shape
    ii = torch.arange(d, dtype=torch.float32, device=device)[:, None, None]
    jj = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    kk = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    return ii, jj, kk


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def affine_resample(x: torch.Tensor, matrix, offset) -> torch.Tensor:
    """Trilinear resample of a (D, H, W) volume under an output→input
    affine map: ``out[o] = interp(x, matrix @ o + offset)``, zero for any
    sample point outside the input domain (scipy's ``mode="constant"``).
    ``matrix`` (3, 3) and ``offset`` (3,) are host arrays (numpy or CPU
    tensors), read as f32."""
    D, H, W = x.shape
    ii, jj, kk = _grid(x.shape, x.device)
    m = [[float(v) for v in row] for row in _f32(matrix)]
    off = [float(v) for v in _f32(offset)]
    # JAX's order of f32 operations (m·i + m·j + m·k + off), so that the
    # floor below lands on the same integer at integer coordinates
    cd = m[0][0] * ii + m[0][1] * jj + m[0][2] * kk + off[0]
    ch = m[1][0] * ii + m[1][1] * jj + m[1][2] * kk + off[1]
    cw = m[2][0] * ii + m[2][1] * jj + m[2][2] * kk + off[2]

    f = x.reshape(-1).float()
    d0 = torch.floor(cd).to(torch.int64)
    h0 = torch.floor(ch).to(torch.int64)
    w0 = torch.floor(cw).to(torch.int64)
    wd, wh, ww = cd - d0, ch - h0, cw - w0

    def corner(dd, hh, wc):
        # clamped indices; output voxels outside the domain are masked
        # wholesale below, so no per-corner mask
        lin = ((d0 + dd).clamp(0, D - 1) * H + (h0 + hh).clamp(0, H - 1)) * W \
            + (w0 + wc).clamp(0, W - 1)
        return torch.take(f, lin)

    out = torch.zeros((D, H, W), dtype=torch.float32, device=x.device)
    for dd, hh, wc in itertools.product((0, 1), repeat=3):
        wgt = (wd if dd else 1.0 - wd) * (wh if hh else 1.0 - wh) * (ww if wc else 1.0 - ww)
        out = out + wgt * corner(dd, hh, wc)
    inside = ((cd >= 0) & (cd <= D - 1) & (ch >= 0) & (ch <= H - 1)
              & (cw >= 0) & (cw <= W - 1))
    return torch.where(inside, out, torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# the 3-pass (Catmull–Smith) form: along one axis the sample position is
# linear in the coordinates, so each pass is a static set of shifted
# slices blended with per-voxel weights.  Three chained linear
# interpolations, not one trilinear: not bit-equal to scipy.
# ---------------------------------------------------------------------------


def _pass_coeffs(m, off):
    """Per-pass linear sample-position coefficients (a_i, a_j, a_k, c)
    of the 3-pass decomposition of ``in = m @ out + off``, passes in the
    order axis 0, 1, 2.  ``m`` and ``off`` are np.float32 arrays, so the
    arithmetic is f32 as JAX's."""
    p2 = (m[2, 0], m[2, 1], m[2, 2], off[2])
    r = m[1, 2] / m[2, 2]
    p1 = (m[1, 0] - r * m[2, 0], m[1, 1] - r * m[2, 1], r, off[1] - r * off[2])
    det = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
    b01 = (m[0, 1] * m[2, 2] - m[0, 2] * m[2, 1]) / det
    b02 = (m[0, 2] * m[1, 1] - m[0, 1] * m[1, 2]) / det
    p0 = (m[0, 0] - b01 * m[1, 0] - b02 * m[2, 0], b01, b02,
          off[0] - b01 * off[1] - b02 * off[2])
    return p0, p1, p2


def shear_shift_bounds(shape, *, rotate_range: float, translate_range: float,
                       scale_range: float, safety: int = 2) -> tuple:
    """Per-pass integer shift bounds for :func:`affine_resample_shear`,
    over the extreme corners of the parameter box (each angle in {-r, 0,
    r}, each scale in {1-s, 1+s}, each translation sign), so that one
    bound covers every draw of a run.  Host numpy."""
    D, H, W = shape
    best = [0, 0, 0]
    angs = (-rotate_range, 0.0, rotate_range)
    scls = (1.0 - scale_range, 1.0 + scale_range)
    exts = (D - 1, H - 1, W - 1)

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        mm = np.eye(3)
        i, j = [k for k in range(3) if k != axis]
        mm[i, i], mm[i, j], mm[j, i], mm[j, j] = c, -s, s, c
        return mm

    for a0, a1, a2 in itertools.product(angs, angs, angs):
        R = rot(0, a0) @ rot(1, a1) @ rot(2, a2)
        for s0, s1, s2 in itertools.product(scls, scls, scls):
            M = R @ np.diag((s0, s1, s2))
            c_in = (np.asarray(shape) - 1) / 2.0
            # the centre shift's sign is set by M: enumerate only the free
            # translation signs
            center = c_in - M @ c_in
            for sg in itertools.product((-1.0, 1.0), repeat=3):
                off_vec = center - np.asarray(sg) * translate_range
                coeffs = _pass_coeffs(np.asarray(M, np.float32), np.asarray(off_vec, np.float32))
                for axis, (ai, aj, ak, cc) in enumerate(coeffs):
                    ai, aj, ak, cc = map(float, (ai, aj, ak, cc))
                    own = (ai, aj, ak)[axis]
                    others = [v for n, v in enumerate((ai, aj, ak)) if n != axis]
                    oexts = [e for n, e in enumerate(exts) if n != axis]
                    # |position - own coordinate| is linear over the box:
                    # its extreme is at a corner
                    dev = max(
                        abs((own - 1.0) * e0 + others[0] * e1 + others[1] * e2 + cc)
                        for e0 in (0.0, float(exts[axis]))
                        for e1 in (0.0, float(oexts[0]))
                        for e2 in (0.0, float(oexts[1]))
                    )
                    best[axis] = max(best[axis], int(np.ceil(dev)) + safety)
    return tuple(best)


def _resample_axis(x, axis, coeffs, max_shift):
    """One pass: resample ``x`` along ``axis`` at the positions
    ``a_i·i + a_j·j + a_k·k + c`` (linear, zero outside)."""
    ai, aj, ak, c = (float(v) for v in coeffs)
    ii, jj, kk = _grid(x.shape, x.device)
    p = ai * ii + aj * jj + ak * kk + c
    own = (ii, jj, kk)[axis]
    n = torch.floor(p)
    f = p - n
    rel = (n - own).to(torch.int32)  # the integer shift of each voxel

    npad = max_shift + 1
    pad = [0, 0] * 3
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = npad  # F.pad lists the last axis first
    xp = F.pad(x, pad)
    size = x.shape[axis]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    out = torch.zeros_like(x)
    for s in range(-max_shift, max_shift + 2):
        # x[own + s] enters as corner n (weight 1 - f) where rel == s and
        # as corner n + 1 (weight f) where rel == s - 1
        w = torch.where(rel == s, 1.0 - f, zero) + torch.where(rel == s - 1, f, zero)
        out = out + w * xp.narrow(axis, npad + s, size)
    inside = (p >= 0) & (p <= size - 1)
    return torch.where(inside, out, zero)


def affine_resample_shear(x: torch.Tensor, matrix, offset, max_shifts) -> torch.Tensor:
    """3-pass resample of a (D, H, W) volume under the output→input map:
    interior values agree with :func:`affine_resample` to ~1e-2 on smooth
    volumes.  ``max_shifts`` is :func:`shear_shift_bounds`'s tuple; it
    covers every in-range draw, else edge voxels clip to 0."""
    p0, p1, p2 = _pass_coeffs(_f32(matrix), _f32(offset))
    y = _resample_axis(x.float(), 0, p0, int(max_shifts[0]))
    y = _resample_axis(y, 1, p1, int(max_shifts[1]))
    return _resample_axis(y, 2, p2, int(max_shifts[2]))


def _host(params: Dict, key: str) -> np.ndarray:
    v = params[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _augment_one(x: torch.Tensor, p: Dict[str, np.ndarray], max_shifts=None) -> torch.Tensor:
    """One (D, H, W) f32 volume through the chain with the host's drawn
    parameters of one sample (numpy scalars and arrays)."""
    x = x.float()
    if bool(p["affine_fired"]):  # RandAffined
        if max_shifts is not None:
            x = affine_resample_shear(x, p["matrix"], p["offset"], max_shifts)
        else:
            x = affine_resample(x, p["matrix"], p["offset"])
    if bool(p["contrast_fired"]):  # RandAdjustContrastd
        mn, mx = torch.aminmax(x)
        rngv = torch.clamp(mx - mn, min=1e-7)
        x = ((x - mn) / rngv) ** float(np.float32(p["gamma"])) * rngv + mn
    if bool(p["shift_fired"]):  # RandShiftIntensityd
        x = x + float(np.float32(p["shift"]))
    if bool(p["noise_fired"]):  # RandGaussianNoised, a device stream per sample
        gen = torch.Generator(device=x.device).manual_seed(int(p["noise_seed"]))
        noise = torch.randn(x.shape, generator=gen, dtype=torch.float32, device=x.device)
        x = x + float(np.float32(p["noise_std"])) * noise
    return torch.clamp(x, 0.0, 1.0)  # the two ThresholdIntensityd clamps


def augment_batch(batch: torch.Tensor, params: Dict, max_shifts=None) -> torch.Tensor:
    """(B, D, H, W[, 1]) batch → the augmented batch, f32 in [0, 1], on
    the batch's device.  ``params`` is the loader's collated
    ``batch["augment"]`` (numpy arrays with a leading B; tensors are read
    back to the host).  ``max_shifts`` (:func:`shear_shift_bounds`)
    selects the 3-pass affine; None the exact gather."""
    squeeze = batch.dim() == 5
    x = batch[..., 0] if squeeze else batch
    host = {k: _host(params, k) for k in params}
    out = torch.stack([
        _augment_one(x[b], {k: v[b] for k, v in host.items()}, max_shifts)
        for b in range(x.shape[0])
    ])
    return out[..., None] if squeeze else out


def make_augment_fn():
    """``(batch, params[, max_shifts]) -> batch``, to compose with a
    train step."""
    return augment_batch
