"""The fused slim residual layer of the VQ-VAE: the CUDA kernel and its plain twin.

Port of ``synthanatomy_tpu/ops/res_stack_pallas.py::fused_residual_layer``
(TPU kernels ``_res_kernel`` :116 and ``_res_bwd_kernel`` :271).  The
layer is

    y = relu(x + conv1³(relu(conv3³(x) + b1)) + b2)

on x (B, C, D, H, W) in the compute dtype, with PyTorch's conv weights:
w1 (R, C, 3, 3, 3), b1 (R,), w2 (C, R, 1, 1, 1), b2 (C,), each cast to
x's dtype as JAX's ``TorchConv3d`` casts them.  Rounding as JAX's module
path: each conv sums in f32 and is rounded to the compute dtype before
its bias is added; bias adds, relus and the residual are in the compute
dtype.  The backward, from saved x, h and y, follows the Pallas kernel:
g_r = gy·[y>0], da = rnd(g_r·W2ᵀ)·[h>0], dx = rnd(conv3ᵀ(da, W1)) + g_r,
and dW1, dW2, db1, db2 in f32.

A CUDA tensor launches ``csrc/res_stack.cu`` or raises; a CPU tensor
takes the plain version (``residual_layer_plain`` /
``residual_layer_bwd_plain``: the same products in f32 on operands
rounded to the compute dtype, rounded at the same points;
``residual_layer_reference`` is its output alone, the twin of JAX's
``residual_layer_reference``).  The library picks the kernels from the
shape (``csrc/res_plan.h``): bf16 with C and R multiples of 8 up to 128
take the tensor-core tile route (``csrc/res_tile.cuh``), which reads
and writes channels-last volumes (``torch.channels_last_3d`` strides);
the rest the GEMM route, on NCDHW.  x may come in either memory format:
only what is not in the kernels' layout is converted, and y and dx come
back in x's format, so a stack of fused layers handed channels-last
volumes (``kernel_layout``) converts nothing.
``fused_residual_layer.launches`` counts forward calls into the library
and ``fused_residual_layer.bwd_launches`` backward calls (each backward
call enqueues five kernels on the tile route: da with the dW2 and bias
partials, dx, the dW1 partials and two fixed-order reductions; seven on
the GEMM route: da, dx, three partial-sum kernels and their reduction).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK, load_library

__all__ = [
    "fused_residual_layer",
    "fused_residual_layer_plain",
    "kernel_layout",
    "residual_layer_bwd_plain",
    "residual_layer_plain",
    "residual_layer_reference",
    "supports_fused_residual",
]

_MAX_R = 512  # csrc/res_stack.cu kMaxR: a block's h tile lives in shared memory
_MAX_VOXELS = 1 << 24  # the kernels' float-reciprocal voxel index split
# voxels per partial sum of the weight gradients on the GEMM route (the
# tile route's chunks are in csrc/res_plan.h)
_CHUNK = 16384


def supports_fused_residual(x_shape, res_channels: int) -> bool:
    """The CUDA kernel's gate: a 5-D NCDHW input, at most 512 hidden
    channels and fewer than 2^24 voxels per volume.  The TPU kernel's
    128-lane channel and 8-sublane W rules do not apply here."""
    if len(x_shape) != 5 or min(x_shape) < 1 or not 1 <= res_channels <= _MAX_R:
        return False
    _, _, d, h, w = x_shape
    return d * h * w < _MAX_VOXELS


def _bias(b, dt):
    return b.to(dt)[:, None, None, None]


# ---------------------------------------------------------------------------
# plain PyTorch version (forward and backward), the kernels' rounding
# ---------------------------------------------------------------------------


def _conv_f32(x, w, padding):
    """conv with operands in x's dtype, summed in f32, rounded to x's dtype"""
    return F.conv3d(x.float(), w.to(x.dtype).float(), padding=padding).to(x.dtype)


def residual_layer_plain(x, w1, b1, w2, b2):
    """Forward → (y, h), both in x's dtype."""
    dt = x.dtype
    h = torch.relu(_conv_f32(x, w1, 1) + _bias(b1, dt))
    y = torch.relu(_conv_f32(h, w2, 0) + _bias(b2, dt) + x)
    return y, h


def residual_layer_reference(x, w1, b1, w2, b2):
    """The layer's output alone, differentiable by autograd: the twin of
    JAX's ``residual_layer_reference``."""
    return residual_layer_plain(x, w1, b1, w2, b2)[0]


def residual_layer_bwd_plain(x, h, y, gy, w1, w2):
    """Backward from saved x, h, y and gy (all in the compute dtype) →
    (dx in the compute dtype, dw1, db1, dw2, db2 in f32)."""
    dt = x.dtype
    c, r = w2.shape[0], w2.shape[1]
    gr = torch.where(y > 0, gy.to(dt), torch.zeros((), dtype=dt, device=x.device))
    w2f = w2.to(dt).float().reshape(c, r)
    dh = torch.einsum("bcdhw,cr->brdhw", gr.float(), w2f)
    da = torch.where(h > 0, dh, torch.zeros((), device=x.device)).to(dt)
    dx = F.conv_transpose3d(da.float(), w1.to(dt).float(), padding=1).to(dt) + gr
    dw1 = torch.nn.grad.conv3d_weight(x.float(), tuple(w1.shape), da.float(), padding=1)
    dw2 = torch.einsum("brdhw,bcdhw->cr", h.float(), gr.float()).reshape(w2.shape)
    return dx, dw1, da.float().sum((0, 2, 3, 4)), dw2, gr.float().sum((0, 2, 3, 4))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("res_stack")
    lib.res_fwd.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8
    lib.res_bwd.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 11
    lib.res_fwd.restype = lib.res_bwd.restype = lib.res_route.restype = ctypes.c_int
    lib.res_route.argtypes = [ctypes.c_int] * 3
    lib.res_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.res_part_floats.argtypes = [ctypes.c_int] * 8
    lib.res_smem_bytes.restype = lib.res_part_floats.restype = ctypes.c_longlong
    return lib


def _code(dtype):
    return int(dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _tile_route(c, r, dtype) -> bool:
    """Whether the library takes (C, R) in dtype on its tile route."""
    return bool(_lib().res_route(c, r, _code(dtype)))


def _memory_format(x):
    """channels_last_3d where x is laid out so (and not also plainly
    contiguous, as a tensor with one channel is), else contiguous."""
    if x.is_contiguous(memory_format=torch.channels_last_3d) and not x.is_contiguous():
        return torch.channels_last_3d
    return torch.contiguous_format


def kernel_layout(x, res_channels: int):
    """x in the memory format that the kernels of a layer with
    ``res_channels`` hidden channels read: channels-last on the tile
    route, NCDHW on the GEMM route (a copy only where x is not so
    already).  A CPU tensor comes back as it is: the plain version takes
    either format."""
    if x.device.type != "cuda":
        return x
    return _in_layout(x, _tile_route(x.shape[1], res_channels, x.dtype))


def _in_layout(t, tile):
    return t.contiguous(memory_format=torch.channels_last_3d if tile else torch.contiguous_format)


def _check_kernel_inputs(x, w1, b1, w2, b2):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"residual kernel takes f32 or bf16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, C, D, H, W), got {tuple(x.shape)}")
    r, c = w1.shape[0], x.shape[1]
    if (tuple(w1.shape) != (r, c, 3, 3, 3) or tuple(w2.shape) != (c, r, 1, 1, 1)
            or tuple(b1.shape) != (r,) or tuple(b2.shape) != (c,)):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(b2.shape)} do not fit a slim layer on {tuple(x.shape)}")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")
    if not supports_fused_residual(x.shape, r):
        raise ValueError(f"the residual kernel does not take x {tuple(x.shape)} with R={r}")
    smem = _lib().res_smem_bytes(c, r, _code(x.dtype))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"R={r} needs {smem} bytes of shared memory per block")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernel_fwd(x, w1, b1, w2, b2, need_h):
    """→ (x, y, h) in the route's layout: x as the kernels read it, for
    the backward to save (h None unless need_h)."""
    b, c, d, hh, w = x.shape
    r = w1.shape[0]
    tile = _tile_route(c, r, x.dtype)
    x = _in_layout(x, tile)
    if tile:  # w1 (27, R, C), w2 (C, R)
        w1k = w1.permute(2, 3, 4, 0, 1).reshape(27, r, c).contiguous()
        w2k = w2.reshape(c, r).contiguous()
    else:  # w1 (27, C, R), w2 (R, C)
        w1k = w1.permute(2, 3, 4, 1, 0).reshape(27, c, r).contiguous()
        w2k = w2.reshape(c, r).t().contiguous()
    y = torch.empty_like(x)
    h = torch.empty(b, r, d, hh, w, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d if tile else torch.contiguous_format
                    ) if need_h else None
    err = _lib().res_fwd(
        b, c, r, d, hh, w, _code(x.dtype), x.data_ptr(), w1k.data_ptr(),
        b1.contiguous().data_ptr(), w2k.data_ptr(), b2.contiguous().data_ptr(), y.data_ptr(),
        None if h is None else h.data_ptr(), _stream(x))
    if err:
        raise RuntimeError(f"res_fwd: CUDA error {err}")
    fused_residual_layer.launches += 1
    return x, y, h


def _kernel_bwd(x, h, y, gy, w1, w2):
    """→ (dx in the route's layout, dw1, db1, dw2, db2 in f32)."""
    b, c, d, hh, w = x.shape
    r = w1.shape[0]
    tile = _tile_route(c, r, x.dtype)
    x, h, y, gy = (_in_layout(t, tile) for t in (x, h, y, gy))
    if tile:  # w1 (27, C, R)
        w1k = w1.permute(2, 3, 4, 1, 0).reshape(27, c, r).contiguous()
    else:  # w1 (27, R, C)
        w1k = w1.permute(2, 3, 4, 0, 1).reshape(27, r, c).contiguous()
    w2t = w2.reshape(c, r).t().contiguous()
    size = 28 * c * r + r + c
    dx = torch.empty_like(x)
    da = torch.empty_like(h)
    part = torch.empty(_lib().res_part_floats(b, c, r, d, hh, w, _code(x.dtype), _CHUNK),
                       dtype=torch.float32, device=x.device)
    out = torch.empty(size, dtype=torch.float32, device=x.device)
    err = _lib().res_bwd(
        b, c, r, d, hh, w, _code(x.dtype), _CHUNK, x.data_ptr(), h.data_ptr(),
        y.data_ptr(), gy.data_ptr(), w2t.data_ptr(), w1k.data_ptr(), dx.data_ptr(),
        da.data_ptr(), part.data_ptr(), out.data_ptr(), _stream(x))
    if err:
        raise RuntimeError(f"res_bwd: CUDA error {err}")
    fused_residual_layer.bwd_launches += 1
    n1, n2 = 27 * c * r, 28 * c * r
    dw1 = out[:n1].reshape(3, 3, 3, c, r).permute(4, 3, 0, 1, 2)
    dw2 = out[n1:n2].reshape(r, c).t().reshape(c, r, 1, 1, 1)
    return dx, dw1, out[n2:n2 + r], dw2, out[n2 + r:]


# ---------------------------------------------------------------------------
# autograd and the public entry
# ---------------------------------------------------------------------------


class _Plain:  # either memory format
    @staticmethod
    def fwd(x, w1, b1, w2, b2, need_h):
        return (x, *residual_layer_plain(x, w1, b1, w2, b2))

    bwd = staticmethod(residual_layer_bwd_plain)


class _Kernel:
    fwd = staticmethod(_kernel_fwd)
    bwd = staticmethod(_kernel_bwd)


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, impl, need_grad):
        dt = x.dtype
        ctx.fmt, ctx.impl = _memory_format(x), impl
        w1c, w2c = w1.to(dt), w2.to(dt)
        x, y, h = impl.fwd(x, w1c, b1.to(dt), w2c, b2.to(dt), need_grad)
        if need_grad:  # h is written only when a gradient is wanted
            ctx.save_for_backward(x, h, y, w1c, w2c)
        return y.contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, gy):
        x, h, y, w1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = ctx.impl.bwd(x, h, y, gy.to(x.dtype), w1, w2)
        return dx.contiguous(memory_format=ctx.fmt), dw1, db1, dw2, db2, None, None


def _apply(impl, x, w1, b1, w2, b2):
    need = torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2))
    return _Fused.apply(x, w1, b1, w2, b2, impl, need)


def fused_residual_layer(x, w1, b1, w2, b2):
    """The fused layer (see the module docstring) → y in x's dtype.  CUDA
    tensors launch the kernels (anything they cannot take raises); CPU
    tensors take the plain version.  Weight gradients come back in f32
    and autograd casts them to the parameters' dtype."""
    if x.device.type == "cpu":
        return _apply(_Plain, x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no residual kernel for device {x.device}")
    _check_kernel_inputs(x, w1, b1, w2, b2)
    return _apply(_Kernel, x, w1, b1, w2, b2)


def fused_residual_layer_plain(x, w1, b1, w2, b2):
    """The plain version of :func:`fused_residual_layer` on any device
    (forward and backward), for holding the kernels against it."""
    return _apply(_Plain, x, w1, b1, w2, b2)


fused_residual_layer.launches = 0
fused_residual_layer.bwd_launches = 0
