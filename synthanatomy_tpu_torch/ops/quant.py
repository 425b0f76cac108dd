"""Weights-only quantization for the decode hot path.

Port of ``synthanatomy_tpu/ops/quant.py``.  The quantizers
(``quantize_int8``, ``quantize_int4_packed``, ``unpack_int4``) are
bit-exact against it: rounding is half-to-even (``torch.round`` like
``jnp.rint``) and the int4 format is split along the contraction dim —
byte ``k`` holds row ``k`` in the low nibble and row ``k + K/2`` in the
high nibble.  Their main consumer is the fused decode kernel
(``csrc/fused_decode.cu``).

``int8_matmul`` is the quantized GEMV (TPU kernel ``_kernel`` :103 under
``int8_matmul`` :139): a CUDA tensor launches ``csrc/int8_matmul.cu`` or
raises, a CPU tensor takes ``int8_matmul_plain``, the kernel's
arithmetic — bf16(x)·bf16(w_q) summed in f32, then × scale.
``int8_matmul_ref`` is JAX's XLA path, which rounds w_q·scale to bf16
BEFORE the product (``quant.py:97``); it differs from the kernel by about
2^-8 relative, deliberately, as the two JAX paths differ.
``int4_matmul`` (not exported) is the packed-int4 product the int4
probes run, from the same source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from synthanatomy_tpu_torch._build import load_library

__all__ = [
    "quantize_int8",
    "quantize_int4_packed",
    "unpack_int4",
    "int8_matmul",
    "int8_matmul_plain",
    "int8_matmul_ref",
]


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float weights → (w_q int8 (K, N), scale f32 (1, N)).

    Symmetric per-output-channel: ``w ≈ w_q * scale``."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_int4_packed(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float weights → (packed int8 (K/2, N), scales f32 (2, N)).

    Two int4 values per byte, split along K (low nibble: rows [0, K/2),
    high nibble: rows [K/2, K)), one scale per (half, out channel),
    symmetric ±7 levels."""
    w = w.to(torch.float32)
    k = w.shape[0]
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    halves = w.reshape(2, k // 2, -1)
    absmax = halves.abs().amax(dim=1)  # (2, N)
    scale = torch.clamp(absmax, min=1e-12) / 7.0
    q = torch.clamp(torch.round(halves / scale[:, None, :]), -7, 7).to(torch.int32)
    packed = ((q[1] & 15) << 4) | (q[0] & 15)
    # values in [0, 255] → two's-complement int8 carrier
    return packed.to(torch.uint8).view(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (K/2, N) int8 → (lo, hi) int32 halves in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = ((p & 15) ^ 8) - 8
    hi = (((p >> 4) & 15) ^ 8) - 8
    return lo, hi


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """JAX's XLA path: x (R, K) · bf16(bf16(w_q) · bf16(scale)) → (R, N) f32."""
    w = w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    return _bf16(x) @ w.to(torch.float32)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: (bf16(x) · w_q) in f32, then × scale.
    x (R, K), w_q (K, N) int8, scale (1, N) → (R, N) f32."""
    return (_bf16(x) @ w_q.to(torch.float32)) * scale.to(torch.float32).reshape(1, -1)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (R, K) · packed int4 (K/2, N) with per-half scales (2, N):
    (bf16(x_lo) · lo) × s[0] + (bf16(x_hi) · hi) × s[1], f32."""
    lo, hi = unpack_int4(packed)
    kh = lo.shape[0]
    xb = _bf16(x)
    return ((xb[:, :kh] @ lo.to(torch.float32)) * scale[0:1]
            + (xb[:, kh:] @ hi.to(torch.float32)) * scale[1:2])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("int8_matmul")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.int8_matmul.argtypes = [i] * 3 + [p] * 4 + [i, i, p]
    lib.int4_matmul.argtypes = [i] * 4 + [p] * 4 + [i, i, p]
    lib.int8_matmul.restype = lib.int4_matmul.restype = i
    for name in ("gemv_matmul_blocks", "gemv_matmul_smem"):
        getattr(lib, name).argtypes = [i] * 4
        getattr(lib, name).restype = i
    return lib


def _vec_ok(t: torch.Tensor, n: int) -> int:
    """16-byte loads need rows of a multiple of 16 bytes and an aligned base."""
    return int(n % 16 == 0 and t.data_ptr() % 16 == 0)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cuda(name, x, w, scale, scale_rows):
    dev = x.device
    for nm, t in (("x", x), (name, w), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{nm} is on {t.device}, x on {dev}")
    if w.dtype != torch.int8:
        raise TypeError(f"{name} must be int8, got {w.dtype}")
    if scale.numel() != scale_rows * w.shape[-1]:
        raise ValueError(f"scale {tuple(scale.shape)} does not fit {name} {tuple(w.shape)}")


def _launch(xf, w, sf, int4, layers=1):
    """One launch of ``csrc/int8_matmul.cu`` on contiguous x (R, K) f32,
    weights (K, N) int8 or (layers, K/2, N) packed and their f32 scales →
    (R, N) f32."""
    r, k = xf.shape
    n = w.shape[-1]
    out = torch.empty(r, n, dtype=torch.float32, device=xf.device)
    lib = _lib()
    vec_x = int(k % 16 == 0 and xf.data_ptr() % 16 == 0)
    args = (xf.data_ptr(), w.data_ptr(), sf.data_ptr(), out.data_ptr(), _vec_ok(w, n), vec_x,
            _stream(xf.device))
    err = (lib.int4_matmul(r, k, n, layers, *args) if int4 else lib.int8_matmul(r, k, n, *args))
    if err != 0:
        raise RuntimeError(f"{'int4' if int4 else 'int8'}_matmul: CUDA error {err}")
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) × w_q (K, N) int8 with per-channel scale (1, N) →
    (..., N) f32.  CUDA tensors launch the kernel (any R, K, N) or raise;
    CPU tensors take :func:`int8_matmul_plain`.  ``int8_matmul.launches``
    counts kernel launches."""
    k, n = w_q.shape
    lead = x.shape[:-1]
    xf = x.to(torch.float32).reshape(-1, k)
    if x.device.type == "cpu":
        return int8_matmul_plain(xf, w_q, scale).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"no int8_matmul kernel for device {x.device}")
    _check_cuda("w_q", x, w_q, scale, 1)
    if xf.shape[0] == 0 or n == 0:
        return torch.empty(*lead, n, dtype=torch.float32, device=x.device)
    out = _launch(xf.contiguous(), w_q.contiguous(), scale.to(torch.float32).contiguous(), False)
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


int8_matmul.launches = 0


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Packed-int4 product for the probes: x (R, K) × packed (K/2, N) int8
    with per-half scales (2, N) → (R, N) f32; with a leading layer axis,
    packed (L, K/2, N) and scale (L, 2, N), one launch walks the L layers
    in order and returns the last layer's product (the TPU grid's
    constant output block).  CPU tensors take :func:`int4_matmul_plain`.
    ``int4_matmul.launches`` counts kernel launches."""
    layered = packed.dim() == 3
    if not layered:
        packed, scale = packed[None], scale.reshape(1, 2, -1)
    n_layers, kh, n = packed.shape
    k = 2 * kh
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not fit packed {tuple(packed.shape)}")
    xf = x.to(torch.float32).reshape(-1, k)
    if x.device.type == "cpu":
        return int4_matmul_plain(xf, packed[-1], scale[-1].to(torch.float32))
    if x.device.type != "cuda":
        raise ValueError(f"no int4_matmul kernel for device {x.device}")
    _check_cuda("packed", x, packed, scale, 2 * n_layers)
    if xf.shape[0] == 0 or n == 0:
        return torch.empty(xf.shape[0], n, dtype=torch.float32, device=x.device)
    out = _launch(xf.contiguous(), packed.contiguous(), scale.to(torch.float32).contiguous(),
                  True, n_layers)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
