"""3D SSIM / MS-SSIM (pytorch_msssim-equivalent math) on NCDHW volumes.

Port of ``synthanatomy_tpu/metrics/ssim.py``.  The reference wraps
``pytorch_msssim.MS_SSIM`` in an Ignite metric
(src/metrics/vqvae.py:12-59) with the window size auto-computed from
the smallest spatial dim (src/utils/vqvae.py:499-544 — reproduced in
:func:`get_ms_ssim_window`).  Math parity: separable Gaussian window
(σ=1.5), K=(0.01, 0.03), data_range 1, 5 scales with the standard
weights, relu-clamped contrast terms, 2× avg-pool between scales.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ssim_3d", "ms_ssim_3d", "get_ms_ssim_window"]

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def get_ms_ssim_window(
    *,
    eval_patch_size: Optional[Sequence[int]] = None,
    roi: Optional[tuple] = None,
    input_shape: Optional[Sequence[int]] = None,
) -> int:
    """Window size rule (reference src/utils/vqvae.py:499-544)."""
    if eval_patch_size:
        min_ps = min(eval_patch_size)
    elif roi:
        if isinstance(roi[0], int):
            min_ps = min(roi)
        else:
            min_ps = min(b - a for a, b in roi)
    elif input_shape:
        min_ps = min(input_shape)
    else:
        raise ValueError("need eval_patch_size, roi or input_shape")

    if min_ps > 160:
        return 11
    win_size = math.floor(((min_ps / 2**4) + 1) / 2)
    if win_size <= 1:
        raise ValueError(
            "Window size for MS-SSIM can't be calculated. Please increase "
            "patch_size's smallest dimension."
        )
    if win_size % 2 == 0:
        win_size += 1
    return win_size


def _gaussian_kernel(win_size: int, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur3d(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable 'valid' Gaussian filtering over D, H, W of
    (B, C, D, H, W), one depthwise convolution an axis."""
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    c = x.shape[1]
    for axis in range(3):
        shape = [1, 1, 1]
        shape[axis] = k.shape[0]
        w = k.reshape(1, 1, *shape).expand(c, 1, *shape)
        x = F.conv3d(x, w, groups=c)
    return x


def _ssim_parts(x, y, win_size, data_range=1.0, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel(win_size)

    mu_x = _blur3d(x, kern)
    mu_y = _blur3d(y, kern)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _blur3d(x * x, kern) - mu_xx
    sigma_yy = _blur3d(y * y, kern) - mu_yy
    sigma_xy = _blur3d(x * y, kern) - mu_xy

    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3, 4)), cs.mean(dim=(1, 2, 3, 4))


def ssim_3d(y_pred: torch.Tensor, y: torch.Tensor, *, win_size: int = 11,
            data_range: float = 1.0) -> torch.Tensor:
    """Mean single-scale SSIM over the batch; inputs (B, C, D, H, W)."""
    s, _ = _ssim_parts(y_pred.float(), y.float(), win_size, data_range)
    return s.mean()


def ms_ssim_3d(
    y_pred: torch.Tensor,
    y: torch.Tensor,
    *,
    win_size: int = 11,
    data_range: float = 1.0,
    weights: Sequence[float] = _MSSSIM_WEIGHTS,
) -> torch.Tensor:
    """Multi-scale SSIM over (B, C, D, H, W) volumes in [0, 1]."""
    x = y_pred.float()
    t = y.float()
    levels = len(weights)
    mcs = []
    val = None
    for i in range(levels):
        s, cs = _ssim_parts(x, t, win_size, data_range)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x = F.avg_pool3d(x, 2)
            t = F.avg_pool3d(t, 2)
        else:
            val = torch.relu(s)
    result = val ** weights[-1]
    for w, cs in zip(weights[:-1], mcs):
        result = result * cs**w
    return result.mean()
