"""Evaluation metrics on NCDHW volumes (PyTorch's layout).

Port of ``synthanatomy_tpu/metrics``: ``MAE`` / ``MSE`` /
``MultiScaleSSIM`` (reference src/metrics/vqvae.py:12-124, backed by
pytorch_msssim) and the transformer ``CE`` (src/metrics/transformer.py:
11-49).  Each returns a 0-d f32 tensor on its inputs' device.
"""

from synthanatomy_tpu_torch.metrics.classification import ce_metric
from synthanatomy_tpu_torch.metrics.regression import mae, mse
from synthanatomy_tpu_torch.metrics.ssim import get_ms_ssim_window, ms_ssim_3d, ssim_3d

__all__ = [
    "mae",
    "mse",
    "ms_ssim_3d",
    "ssim_3d",
    "get_ms_ssim_window",
    "ce_metric",
]
