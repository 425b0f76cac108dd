"""Banded local-window attention for training: the CUDA kernel and its plain twin.

Port of ``synthanatomy_tpu/ops/local_attention_pallas.py::local_attention_flash``
(TPU kernels ``_fwd_kernel`` :128 and ``_bwd_kernel`` :164).  Rotary
phases are applied outside the kernel, in f32, and q/k/v are then cast
to the compute dtype, as in JAX; non-causal attention takes the plain
``ops/local_attention.local_attention`` on every device, as it takes
XLA's in JAX.

The kernel pair computes, on post-rotary q/k/v (B, H, L, d) in the
compute dtype, attention of query i over keys i − w < j ≤ i with an f32
softmax.  Forward: scores = rnd(q·d^-1/2)·kᵀ, e = exp(s − max), out =
rnd(e)·v / Σe, in the compute dtype.  Backward, recomputed from q/k/v:
scores = (q·kᵀ)·d^-1/2, P = e/Σe, dP = g·vᵀ (g rounded to the compute
dtype), dS = P·(dP − Σ dP·P); dq = rnd(dS)·k·d^-1/2, dk = rnd(dS)ᵀ·q·
d^-1/2, dv = rnd(P)ᵀ·g, each summed in f32 and rounded once (the TPU
kernel rounds each query block's share of dk/dv before folding them).

A CUDA tensor launches ``csrc/local_attention.cu`` (forward: one launch;
backward: two) or raises; a CPU tensor takes the plain version
(``local_fwd_plain`` / ``local_bwd_plain``, dense masked products at the
same rounding points).  ``local_attention_flash.launches`` counts kernel
launches.  The kernels choose their form (the tensor-core tile form on
``csrc/band_attention.cuh`` for d ≤ 128, with no window bound; the
earlier FMA band form above), padded head dim, grids and shared memory
themselves, by ``csrc/band_plan.h``; the wrapper asks the library for the
shared memory (``local_smem_bytes``) before it launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK, load_library
from synthanatomy_tpu_torch.ops.local_attention import (
    apply_rotary,
    local_attention,
    rotary_sin_cos,
    rounded,
)

__all__ = [
    "local_attention_flash",
    "local_attention_flash_core",
    "local_attention_flash_plain",
    "local_fwd_plain",
    "local_bwd_plain",
]

# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _band(n, window, device):
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return (j <= i) & (j > i - window)


def local_fwd_plain(q, k, v, window):
    """q, k, v: (..., L, d) post-rotary in the compute dtype → (..., L, d)
    in the compute dtype."""
    cd = q.dtype
    scale = q.shape[-1] ** -0.5
    s = rounded(q.float() * scale, cd) @ k.float().transpose(-1, -2)
    s = s.masked_fill(~_band(q.shape[-2], window, q.device), float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return ((rounded(e, cd) @ v.float()) / e.sum(-1, keepdim=True)).to(cd)


def local_bwd_plain(q, k, v, g, window, out_dtype=None):
    """Recomputing backward; g in the compute dtype → (dq, dk, dv) in the
    compute dtype (or in ``out_dtype``)."""
    cd = q.dtype
    od = out_dtype or cd
    scale = q.shape[-1] ** -0.5
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~_band(q.shape[-2], window, q.device), float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (rounded(ds, cd) @ k) * scale
    dk = (rounded(ds, cd).transpose(-1, -2) @ q) * scale
    dv = rounded(p, cd).transpose(-1, -2) @ g
    return dq.to(od), dk.to(od), dv.to(od)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("local_attention")
    head = [ctypes.c_int] * 5 + [ctypes.c_float]
    lib.local_fwd.argtypes = head + [ctypes.c_void_p] * 5
    lib.local_bwd.argtypes = head + [ctypes.c_void_p] * 11
    lib.local_fwd.restype = lib.local_bwd.restype = ctypes.c_int
    lib.local_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.local_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_kernel_inputs(q, k, v, window):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"local attention kernel takes f32 or bf16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, d), got {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name} must match q ({q.dtype}, {tuple(q.shape)}, {q.device}); "
                             f"got {x.dtype}, {tuple(x.shape)}, {x.device}")
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    d = q.shape[-1]
    smem = _lib().local_smem_bytes(d, window, int(q.dtype == torch.bfloat16))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"window {window} at head dim {d} needs {smem} bytes of shared memory "
                         f"per block; the card has {SMEM_PER_BLOCK}")


def _kernel_fwd(q, k, v, window):
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    err = _lib().local_fwd(
        b * h, n, d, window, int(q.dtype == torch.bfloat16), d ** -0.5,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"local_fwd: CUDA error {err}")
    local_attention_flash.launches += 1
    return out


def _kernel_bwd(q, k, v, g, window):
    b, h, n, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    stats = torch.empty(3, b * h, n, dtype=torch.float32, device=q.device)
    err = _lib().local_bwd(
        b * h, n, d, window, int(q.dtype == torch.bfloat16), d ** -0.5,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"local_bwd: CUDA error {err}")
    local_attention_flash.launches += 2
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd and the public entry
# ---------------------------------------------------------------------------


class _Plain:
    fwd = staticmethod(local_fwd_plain)
    bwd = staticmethod(local_bwd_plain)


class _Kernel:
    fwd = staticmethod(_kernel_fwd)
    bwd = staticmethod(_kernel_bwd)


class _LocalFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, impl):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.impl = window, impl
        return impl.fwd(q, k, v, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = ctx.impl.bwd(q, k, v, g, ctx.window)
        return dq, dk, dv, None, None


def local_attention_flash_core(q, k, v, window: int):
    """The kernel pair on post-rotary q/k/v (B, H, L, d) in the compute
    dtype → (B, H, L, d) in the compute dtype.  CUDA tensors launch the
    kernels (anything they cannot take raises); CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return _LocalFlash.apply(q, k, v, window, _Plain)
    if q.device.type != "cuda":
        raise ValueError(f"no local attention kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, window)
    return _LocalFlash.apply(q, k, v, window, _Kernel)


def local_attention_flash_plain(q, k, v, window: int):
    """The plain version of :func:`local_attention_flash_core` on any
    device (forward and backward), for holding the kernels against it."""
    return _LocalFlash.apply(q, k, v, window, _Plain)


def local_attention_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    causal: bool = True,
    use_rotary: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Drop-in for ``ops.local_attention.local_attention`` through the
    kernel pair: q, k, v (B, H, L, d) → (B, H, L, d) in v's dtype."""
    if not causal:
        return local_attention(q, k, v, window=window, causal=False, use_rotary=use_rotary,
                               compute_dtype=compute_dtype)
    in_dtype = v.dtype
    if use_rotary:
        sin, cos = rotary_sin_cos(q.shape[-1], torch.arange(q.shape[2], device=q.device))
        q = apply_rotary(q.to(torch.float32), sin, cos)
        k = apply_rotary(k.to(torch.float32), sin, cos)
    cd = compute_dtype
    out = local_attention_flash_core(q.to(cd), k.to(cd), v.to(cd), window)
    return out.to(in_dtype)


local_attention_flash.launches = 0
