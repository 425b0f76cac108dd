"""Block-sparse causal local attention (splash form): the CUDA kernel and its plain twin.

Port of ``synthanatomy_tpu/ops/local_attention_splash.py::local_attention_splash``
(:91), which runs JAX's stock splash-attention TPU kernel over
``LocalMask((Lp, Lp), (w-1, 0), 0)`` (``_make_kernel`` :46): key j is
visible to query i iff i − w < j ≤ i.  Same signature and conventions:
rotary in f32 outside the kernel, q scaled by d^-1/2 in f32 and then
cast (in torch ops, so autograd carries the scale: the kernel core takes
none), k and v cast to the compute dtype, L zero-padded to a multiple of
``max(block_q, block_kv)`` with the padded query rows sliced off, and a
non-causal call sent to the plain ``ops/local_attention.local_attention``
on every device.

The tile map (``tile_classes``) marks each (query tile, key tile) pair
empty (skipped), full (no mask) or partial (masked), built on the host
and cached per (Lp, w, tiles) as ``_make_kernel`` caches its mask.

Numerics follow splash (``splash_attention_kernel.py`` in the installed
JAX), not the banded kernel of ``ops/local_attention_flash.py``:

- forward: s = q·kᵀ (compute-dtype operands, f32 sums), masked with
  ``MASK_VALUE`` = −0.7·f32max (finite, so a row whose first visited key
  tile is wholly masked keeps a finite running max), an online softmax in
  f32 over the key tiles, P·V with p and v in f32 (p is not rounded),
  o = acc·(1/l) in the compute dtype and lse = m + log l in f32;
- backward: di = Σ o·do (f32), p = exp(s − lse), dp = do·vᵀ, ds = (dp −
  di)·p; dq = rnd(ds)·k, dk = rnd(ds)ᵀ·q, dv = rnd(p)ᵀ·do, each summed in
  f32 and rounded once; with ``use_fused_bwd`` dq is written per key tile
  in the compute dtype and the partials are then summed, a rounding point
  the unfused form does not have.

A CUDA tensor launches ``csrc/local_attention_splash.cu`` (forward: one
launch; backward: two, dq then dk/dv, or with ``use_fused_bwd`` dk/dv
with dq partials then their reduction) or raises; a CPU tensor takes the
plain version (``splash_fwd_plain`` / ``splash_bwd_plain``).  The
kernel's own tiles are ``KERNEL_TILE`` square; ``block_q``/``block_kv``
set the padding and, in the plain version, the order of the online
softmax and the fused dq partials.  ``local_attention_splash.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from synthanatomy_tpu_torch._build import load_library
from synthanatomy_tpu_torch.ops.local_attention import (
    apply_rotary,
    local_attention,
    rotary_sin_cos,
    rounded,
)

__all__ = [
    "KERNEL_TILE",
    "MASK_VALUE",
    "local_attention_splash",
    "splash_attention_core",
    "splash_attention_plain",
    "splash_bwd_plain",
    "splash_fwd_plain",
    "tile_classes",
]

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # splash's DEFAULT_MASK_VALUE
KERNEL_TILE = 64  # query and key rows of one tile of the CUDA kernel
KERNEL_HEAD_DIM = 64  # the head width the kernel is built for (the paper's)
EMPTY, PARTIAL, FULL = 0, 1, 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=64)
def tile_classes(n_pad: int, window: int, block_q: int, block_kv: int) -> np.ndarray:
    """(n_pad/block_q, n_pad/block_kv) int8: ``EMPTY``, ``PARTIAL`` or
    ``FULL`` for each (query tile, key tile) pair under the local mask.

    Over a tile pair the offset i − j takes every integer from ``lo`` to
    ``hi``; a key is visible at offsets 0 … w−1, so the pair is empty
    when [lo, hi] misses that range and full when it lies inside it."""
    if n_pad % block_q or n_pad % block_kv:
        raise ValueError(f"length {n_pad} is not a multiple of the tiles {block_q}, {block_kv}")
    qt = np.arange(n_pad // block_q)[:, None] * block_q
    kt = np.arange(n_pad // block_kv)[None, :] * block_kv
    lo = qt - (kt + block_kv - 1)
    hi = qt + block_q - 1 - kt
    cls = np.where((hi >= 0) & (lo <= window - 1), PARTIAL, EMPTY).astype(np.int8)
    cls[(lo >= 0) & (hi <= window - 1)] = FULL
    cls.flags.writeable = False
    return cls


def _allowed(n: int, window: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return (j <= i) & (j > i - window)


# ---------------------------------------------------------------------------
# plain PyTorch version, on padded (B, H, Lp, d) inputs in the compute dtype
# ---------------------------------------------------------------------------


def splash_fwd_plain(q, k, v, window: int, block_q: int, block_kv: int):
    """(o in the compute dtype, lse (B, H, Lp) f32): an online softmax over
    the visible key tiles of each query tile, in tile order."""
    cd, n = q.dtype, q.shape[-2]
    cls = tile_classes(n, window, block_q, block_kv)
    allowed = _allowed(n, window, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    for qt in range(cls.shape[0]):
        rows = slice(qt * block_q, (qt + 1) * block_q)
        m = torch.full(q.shape[:-2] + (block_q, 1), MASK_VALUE, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape[:-2] + (block_q, q.shape[-1]), device=q.device)
        for kt in np.flatnonzero(cls[qt]):
            cols = slice(kt * block_kv, (kt + 1) * block_kv)
            s = qf[..., rows, :] @ kf[..., cols, :].transpose(-1, -2)
            if cls[qt, kt] == PARTIAL:
                s = s.masked_fill(~allowed[rows, cols], MASK_VALUE)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            alpha = torch.exp(m - m_next)
            l = p.sum(-1, keepdim=True) + alpha * l
            acc = alpha * acc + p @ vf[..., cols, :]
            m = m_next
        out[..., rows, :] = (acc * (1.0 / l)).to(cd)
        lse[..., rows] = (torch.log(l) + m)[..., 0]
    return out, lse


def splash_bwd_plain(q, k, v, o, lse, do, window: int, block_kv: int, fused: bool):
    """(dq, dk, dv) in the compute dtype, dense over (Lp, Lp); with
    ``fused`` dq is summed from per-``block_kv`` partials rounded to the
    compute dtype."""
    cd, n = q.dtype, q.shape[-2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    di = (o.float() * dof).sum(-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)).masked_fill(~_allowed(n, window, q.device), MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    dp = dof @ vf.transpose(-1, -2)
    ds = rounded((dp - di) * p, cd)
    dv = rounded(p, cd).transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf
    if fused:
        dq = torch.zeros_like(qf)
        for c in range(0, n, block_kv):
            dq = dq + rounded(ds[..., c:c + block_kv] @ kf[..., c:c + block_kv, :], cd)
    else:
        dq = ds @ kf
    return dq.to(cd), dk.to(cd), dv.to(cd)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("local_attention_splash")
    head = [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    lib.splash_fwd.argtypes = head + [ctypes.c_void_p] * 7
    lib.splash_bwd.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p] * 12
    lib.splash_fwd.restype = lib.splash_bwd.restype = ctypes.c_int
    lib.splash_smem_bytes.argtypes = [ctypes.c_int]
    lib.splash_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _device_map(n_pad: int, window: int, device: torch.device):
    """The kernel's tile map on ``device``: (int32 tensor, tiles, pairs).

    Laid out as q_ptr (nt + 1), q_ent (nnz: key tile << 1 | partial, in
    key-tile order), k_ptr (nt + 1), k_ent (nnz: query tile << 1 |
    partial), k_slot (nnz: the pair's index in the q-major list, where
    the fused backward writes its dq partial)."""
    cls = tile_classes(n_pad, window, KERNEL_TILE, KERNEL_TILE)
    nt = cls.shape[0]
    qi, ki = np.nonzero(cls)  # q-major, key tiles ascending
    slot = np.arange(qi.size)
    partial = (cls[qi, ki] == PARTIAL).astype(np.int64)
    q_ptr = np.searchsorted(qi, np.arange(nt + 1))
    order = np.lexsort((qi, ki))  # k-major, query tiles ascending
    k_ptr = np.searchsorted(ki[order], np.arange(nt + 1))
    flat = np.concatenate([q_ptr, (ki << 1) | partial, k_ptr,
                           (qi[order] << 1) | partial[order], slot[order]])
    return torch.as_tensor(flat.astype(np.int32), device=device), nt, int(qi.size)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(x):
    return None if x is None else x.data_ptr()


def _kernel_fwd(q, k, v, window, visits=None):
    b, h, n, d = q.shape
    tmap, nt, nnz = _device_map(n, window, q.device)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
    err = _lib().splash_fwd(
        b * h, n, window, int(q.dtype == torch.bfloat16), tmap.data_ptr(), nt, nnz,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _ptr(visits), _stream(q))
    if err:
        raise RuntimeError(f"splash_fwd: CUDA error {err}")
    local_attention_splash.launches += 1
    return out, lse


def _kernel_bwd(q, k, v, o, lse, do, window, fused, visits=None):
    b, h, n, d = q.shape
    tmap, nt, nnz = _device_map(n, window, q.device)
    di = (o.float() * do.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    part = (torch.empty(nnz, b * h, KERNEL_TILE, d, dtype=q.dtype, device=q.device)
            if fused else None)
    err = _lib().splash_bwd(
        b * h, n, window, int(q.dtype == torch.bfloat16), tmap.data_ptr(), nt, nnz,
        int(fused), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(part),
        _ptr(visits), _stream(q))
    if err:
        raise RuntimeError(f"splash_bwd: CUDA error {err}")
    local_attention_splash.launches += 2
    return dq, dk, dv


def _check_kernel_inputs(q, k, v, window):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"splash kernel takes f32 or bf16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] != KERNEL_HEAD_DIM or q.shape[-2] % KERNEL_TILE:
        raise ValueError(f"q must be (B, H, Lp, {KERNEL_HEAD_DIM}) with Lp a multiple of "
                         f"{KERNEL_TILE}, got {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name} must match q ({q.dtype}, {tuple(q.shape)}, {q.device}); "
                             f"got {x.dtype}, {tuple(x.shape)}, {x.device}")
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")


# ---------------------------------------------------------------------------
# autograd and the public entries
# ---------------------------------------------------------------------------


class _Plain:
    def __init__(self, block_q, block_kv, fused):
        self.block_q, self.block_kv, self.fused = block_q, block_kv, fused

    def fwd(self, q, k, v, window):
        return splash_fwd_plain(q, k, v, window, self.block_q, self.block_kv)

    def bwd(self, q, k, v, o, lse, do, window):
        return splash_bwd_plain(q, k, v, o, lse, do, window, self.block_kv, self.fused)


class _Kernel:
    def __init__(self, fused):
        self.fused = fused

    def fwd(self, q, k, v, window):
        return _kernel_fwd(q, k, v, window)

    def bwd(self, q, k, v, o, lse, do, window):
        return _kernel_bwd(q, k, v, o, lse, do, window, self.fused)


def _aligned(x):
    """Contiguous, at a 16-byte aligned address (the kernel loads 16 bytes a thread)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


class _Splash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, impl):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        o, lse = impl.fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.impl = window, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _aligned(do.to(q.dtype))
        dq, dk, dv = ctx.impl.bwd(q, k, v, o, lse, do, ctx.window)
        return dq, dk, dv, None, None


def splash_attention_core(q, k, v, window: int, block_q: int = 256, block_kv: int = 256,
                          use_fused_bwd: bool = False):
    """Splash attention on padded, pre-scaled q/k/v (B, H, Lp, d) in the
    compute dtype → (B, H, Lp, d) in the compute dtype.  CUDA tensors
    launch the kernels (anything they cannot take raises); CPU tensors
    take the plain version with ``block_q``/``block_kv`` tiles."""
    if q.device.type == "cpu":
        return _Splash.apply(q, k, v, window, _Plain(block_q, block_kv, use_fused_bwd))
    if q.device.type != "cuda":
        raise ValueError(f"no splash attention kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, window)
    return _Splash.apply(q, k, v, window, _Kernel(use_fused_bwd))


def splash_attention_plain(q, k, v, window: int, block_q: int = 256, block_kv: int = 256,
                           use_fused_bwd: bool = False):
    """The plain version of :func:`splash_attention_core` on any device
    (forward and backward), for holding the kernels against it."""
    return _Splash.apply(q, k, v, window, _Plain(block_q, block_kv, use_fused_bwd))


def local_attention_splash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    causal: bool = True,
    use_rotary: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    block_q: int = 256,
    block_kv: int = 256,
    use_fused_bwd: bool = False,
) -> torch.Tensor:
    """Drop-in for ``ops.local_attention.local_attention`` through the
    splash kernels: q, k, v (B, H, L, d) → (B, H, L, d) in v's dtype."""
    if not causal:
        return local_attention(q, k, v, window=window, causal=False, use_rotary=use_rotary,
                               compute_dtype=compute_dtype)
    n, d = q.shape[-2], q.shape[-1]
    in_dtype = v.dtype
    if use_rotary:
        sin, cos = rotary_sin_cos(d, torch.arange(n, device=q.device))
        q = apply_rotary(q.to(torch.float32), sin, cos)
        k = apply_rotary(k.to(torch.float32), sin, cos)
    q = (q.to(torch.float32) * d ** -0.5).to(compute_dtype)
    k, v = k.to(compute_dtype), v.to(compute_dtype)
    n_pad = _round_up(n, max(block_q, block_kv))
    if n_pad != n:
        q, k, v = (F.pad(x, (0, 0, 0, n_pad - n)) for x in (q, k, v))
    out = splash_attention_core(q, k, v, window, min(block_q, n_pad), min(block_kv, n_pad),
                                use_fused_bwd)
    return out[:, :, :n].to(in_dtype)


local_attention_splash.launches = 0
