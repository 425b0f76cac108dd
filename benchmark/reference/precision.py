"""Precision of the reference and of its lower-precision controls."""

from __future__ import annotations

import contextlib

import torch

# the largest finite float8 e4m3 value
_E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    maximum at the format's largest value), held in float32: the operand
    of a product computed in fp8.  The scale is a constant for autograd,
    and the rounding passes the gradient straight through, as in
    fp8 training."""
    scale = (x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX)
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (r - x).detach()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), held in
    float32, as a tensor core reads a float32 operand with TF32 on
    (gradient straight through)."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach())


def lower(cfg: dict):
    """The rounding of the nearest precision below the one ``cfg``
    computes in: fp8 below bfloat16, TF32 below float32 with TF32 off."""
    return fp8 if cfg["compute_dtype"] == "bfloat16" else tf32
