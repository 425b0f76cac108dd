"""The kernels of the decode-side probes, with their plain twins.

Port of the Pallas kernels inside ``tools/probe_int4.py``,
``tools/probe_int4_unpack.py`` and ``tools/probe_pallas_overhead.py``
(their CLIs are ``synthanatomy_tpu_torch/tools/probe_*.py``):

- :func:`weight_stream` — the L-layer weight-stream chain
  ``acc += fold(bf16(x) · W_i · s_i) · 1e-3`` over int8 or packed-int4
  weights (``csrc/weight_stream.cu``);
- :func:`int4_unpack` — one of the four nibble-unpack formulations A-D
  (``csrc/int4_unpack.cu``);
- :func:`tile_steps` — ``steps`` passes of ``acc += x · w`` in bf16 with
  f32 accumulation, written as bf16 (``csrc/launch_overhead.cu``).

Each wrapper launches its kernel for CUDA tensors (checking device,
dtype and shape, raising otherwise) and takes the plain twin
(``*_plain``) for CPU tensors; ``<wrapper>.launches`` counts kernel
launches (``weight_stream.packed_launches`` those with packed
weights).  The packed product of the unpack probe's E and F bodies is
``ops/quant.int4_matmul``.  For the probes' timings,
:func:`tile_steps_plan` and :func:`int4_unpack_grid` give a launch's
geometry and :func:`empty_launch` launches an empty kernel of it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from synthanatomy_tpu_torch._build import load_library
from synthanatomy_tpu_torch.ops.quant import unpack_int4

__all__ = [
    "UNPACK_VARIANTS",
    "weight_stream",
    "weight_stream_plain",
    "int4_unpack",
    "unpack_int4_plain",
    "int4_unpack_grid",
    "tile_steps",
    "tile_steps_plain",
    "tile_steps_plan",
    "empty_launch",
]

# the unpack probe's formulations, in its order
UNPACK_VARIANTS = ("A int32-bitwise", "B int32-arith", "C float-arith", "D int8-bitwise")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    lib = load_library(name)
    if name == "weight_stream":
        i = ctypes.c_int
        lib.weight_stream.argtypes = [i] * 5 + [ctypes.c_void_p] * 5 + [i, i, ctypes.c_void_p]
        lib.weight_stream.restype = i
        lib.gemv_stream_blocks.argtypes = [i] * 3
        lib.gemv_stream_smem.argtypes = [i] * 4
        lib.gemv_stream_blocks.restype = lib.gemv_stream_smem.restype = i
        return lib
    i, p = ctypes.c_int, ctypes.c_void_p
    if name == "int4_unpack":
        lib.int4_unpack.argtypes = [i, i] + [p] * 3
        lib.int4_unpack.restype = i
        lib.int4_unpack_grid.argtypes = [i, p, p, p]
        lib.int4_unpack_grid.restype = None
    else:
        lib.launch_overhead.argtypes = [i] * 4 + [p] * 4
        lib.launch_overhead.restype = i
        lib.launch_overhead_plan.argtypes = [i, i, i, p]
        lib.launch_overhead_plan.restype = i
        lib.launch_overhead_max_k.argtypes = []
        lib.launch_overhead_max_k.restype = i
        lib.launch_empty.argtypes = [i] * 4 + [p]
        lib.launch_empty.restype = i
    return lib


def _require_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    return dev


# ---------------------------------------------------------------------------
# 9a: the weight-stream chain
# ---------------------------------------------------------------------------


def weight_stream_plain(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                        packed: bool = False) -> torch.Tensor:
    """x (B, K); w (L, K, N) int8, or (L, K/2, N) packed int4 with
    ``packed``; s (L, 1, N) f32 → (B, K) f32: for each layer in order,
    acc += fold(bf16(x) · W_i · s_i) · 1e-3, fold summing (B, N/K, K)
    over its middle axis (the packed form scales lo + hi by s_i)."""
    b, k = x.shape
    xb = _bf16(x)
    acc = torch.zeros(b, k, dtype=torch.float32, device=x.device)
    for i in range(w.shape[0]):
        if packed:
            lo, hi = unpack_int4(w[i])
            y = xb[:, : k // 2] @ lo.to(torch.float32) + xb[:, k // 2:] @ hi.to(torch.float32)
        else:
            y = xb @ w[i].to(torch.float32)
        y = y * s[i].reshape(1, -1).to(torch.float32)
        acc = acc + y.reshape(b, -1, k).sum(1) * 1e-3
    return acc


def _stream_launch(xb, w, sf, packed):
    """The two launches of ``csrc/weight_stream.cu`` on contiguous x (B, K)
    bf16, weights (L, K or K/2, N) int8 and scales (L, N) f32 → (B, K) f32."""
    L, _, n = w.shape
    b, k = xb.shape
    partial = torch.empty(L, b, k, dtype=torch.float32, device=xb.device)
    out = torch.empty(b, k, dtype=torch.float32, device=xb.device)
    vec = int(n % 16 == 0 and k % 16 == 0 and w.data_ptr() % 16 == 0)
    vec_x = int(k % 16 == 0 and xb.data_ptr() % 16 == 0)
    err = _lib("weight_stream").weight_stream(
        int(packed), L, b, k, n, xb.data_ptr(), w.data_ptr(), sf.data_ptr(), partial.data_ptr(),
        out.data_ptr(), vec, vec_x, _stream(xb.device))
    if err != 0:
        raise RuntimeError(f"weight_stream: CUDA error {err}")
    return out


def weight_stream(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                  packed: bool = False) -> torch.Tensor:
    """The chain of :func:`weight_stream_plain` in one kernel pass over
    the weights (two launches: the layer partials, then their ordered
    sum; counted as one)."""
    if x.device.type == "cpu":
        return weight_stream_plain(x, w, s, packed)
    _require_cuda("weight_stream", x, w, s)
    L, kr, n = w.shape
    b, k = x.shape
    if w.dtype != torch.int8:
        raise TypeError(f"weights must be int8 (packed int4 rides in int8), got {w.dtype}")
    if kr != (k // 2 if packed else k) or n % k or s.numel() != L * n or (packed and k % 2):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, s {tuple(s.shape)} do not "
                         f"fit (N a multiple of K)")
    out = _stream_launch(x.to(torch.bfloat16).contiguous(), w.contiguous(),
                         s.to(torch.float32).contiguous(), packed)
    weight_stream.launches += 1
    weight_stream.packed_launches += int(packed)
    return out


weight_stream.launches = 0
weight_stream.packed_launches = 0  # the packed-int4 share of launches


# ---------------------------------------------------------------------------
# 9b: the nibble-unpack formulations
# ---------------------------------------------------------------------------


def unpack_int4_plain(packed: torch.Tensor, variant: int) -> torch.Tensor:
    """Packed (K2, N) int8 → (2·K2, N) f32 [lo; hi] by formulation
    ``variant`` (0-3 = A-D of ``UNPACK_VARIANTS``)."""
    if variant == 0:
        p = packed.to(torch.int32)
        lo, hi = ((p & 15) ^ 8) - 8, (((p >> 4) & 15) ^ 8) - 8
    elif variant == 1:
        p = packed.to(torch.int32)

        def fdiv(a, b):
            return torch.div(a, b, rounding_mode="floor")

        pu = p - 256 * fdiv(p, 256)
        hu = fdiv(pu, 16)
        lu = pu - 16 * hu
        lo, hi = lu - 16 * fdiv(lu + 8, 16), hu - 16 * fdiv(hu + 8, 16)
    elif variant == 2:
        p = packed.to(torch.float32)
        pu = p - 256.0 * torch.floor(p / 256.0)
        hu = torch.floor(pu / 16.0)
        lu = pu - 16.0 * hu
        lo, hi = lu - 16.0 * torch.floor((lu + 8.0) / 16.0), hu - 16.0 * torch.floor(
            (hu + 8.0) / 16.0)
    elif variant == 3:
        lo = ((packed & 15) ^ 8) - 8
        hi = (((packed >> 4) & 15) ^ 8) - 8
    else:
        raise ValueError(f"unpack variant must be 0-3, got {variant}")
    return torch.cat([lo, hi], dim=0).to(torch.float32)


def int4_unpack(packed: torch.Tensor, variant: int) -> torch.Tensor:
    """Formulation ``variant`` of the nibble unpack (see
    :func:`unpack_int4_plain`) as one kernel launch: 16 bytes a thread
    over every whole 512 bytes (a warp's) where the pointers are 16-byte
    aligned, one byte a thread past them or where they are not (see
    :func:`int4_unpack_grid`)."""
    if packed.device.type == "cpu":
        return unpack_int4_plain(packed, variant)
    dev = _require_cuda("int4_unpack", packed)
    if packed.dtype != torch.int8 or packed.dim() != 2:
        raise TypeError(f"packed must be a 2-D int8 tensor, got {packed.dtype} "
                        f"{tuple(packed.shape)}")
    if variant not in range(4):
        raise ValueError(f"unpack variant must be 0-3, got {variant}")
    packed = packed.contiguous()
    out = torch.empty(2 * packed.shape[0], packed.shape[1], dtype=torch.float32, device=dev)
    err = _lib("int4_unpack").int4_unpack(variant, packed.numel(), packed.data_ptr(),
                                          out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"int4_unpack: CUDA error {err}")
    int4_unpack.launches += 1
    return out


int4_unpack.launches = 0


def int4_unpack_grid(packed: torch.Tensor) -> dict:
    """The geometry of :func:`int4_unpack`'s launch on ``packed`` (its
    output, from ``torch.empty``, is 16-byte aligned): blocks, threads a
    block, and pieces, the threads that take 16 bytes each."""
    geo = (ctypes.c_int * 3)()
    _lib("int4_unpack").int4_unpack_grid(packed.numel(), packed.data_ptr(), 0, geo)
    return dict(zip(("blocks", "threads", "pieces"), geo))


# ---------------------------------------------------------------------------
# 9c: the tile program of the launch-overhead probe
# ---------------------------------------------------------------------------


def tile_steps_plain(x: torch.Tensor, w: torch.Tensor, steps: int) -> torch.Tensor:
    """x (M, K), w (K, N) bf16 → bf16(Σ over ``steps`` of x · w), each
    product in f32 and added to an f32 accumulator."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(steps):
        acc = acc + xf @ wf
    return acc.to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _tile_max_k() -> int:
    return _lib("launch_overhead").launch_overhead_max_k()


def tile_steps(x: torch.Tensor, w: torch.Tensor, steps: int) -> torch.Tensor:
    """:func:`tile_steps_plain` as one launch whose blocks loop ``steps``
    times over the tensor-core products, K split over a cluster (M and N
    multiples of 64, K of 16 up to 2048; see :func:`tile_steps_plan`)."""
    if x.device.type == "cpu":
        return tile_steps_plain(x, w, steps)
    dev = _require_cuda("tile_steps", x, w)
    (m, k), (k2, n) = x.shape, w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bf16, got {x.dtype} and {w.dtype}")
    if k != k2 or m % 64 or n % 64 or k % 16 or k > _tile_max_k():
        raise ValueError(f"x {tuple(x.shape)} · w {tuple(w.shape)}: M and N must be multiples "
                         f"of 64, K of 16 and at most {_tile_max_k()}")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    err = _lib("launch_overhead").launch_overhead(m, k, n, steps, x.data_ptr(), w.data_ptr(),
                                                  out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"tile_steps: CUDA error {err}")
    tile_steps.launches += 1
    return out


tile_steps.launches = 0

PLAN_KEYS = ("blocks", "threads", "cluster", "products", "smem", "active_clusters")


def tile_steps_plan(m: int, k: int, n: int) -> dict:
    """The plan of :func:`tile_steps` at (M, K, N), asked of the library
    (``csrc/overhead_plan.h``): blocks, threads a block, cluster (the
    splits of K), products (k16 products a split each step), smem (bytes a
    block) and active_clusters (how many such clusters the card holds at
    once: every cluster of the grid is resident when it is at least
    blocks / cluster)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    if _lib("launch_overhead").launch_overhead_plan(m, k, n, out) != 0:
        raise ValueError(f"tile_steps takes no (M, K, N) = {(m, k, n)}")
    return dict(zip(PLAN_KEYS, out))


def empty_launch(device, blocks: int, threads: int, cluster: int = 1, smem: int = 0) -> None:
    """One launch of an empty kernel of this geometry on ``device``'s
    current stream (``csrc/launch_overhead.cu``): the floor of a kernel of
    that grid, for the probes.  No path runs it; it counts nothing."""
    err = _lib("launch_overhead").launch_empty(blocks, threads, cluster, smem,
                                               _stream(torch.device(device)))
    if err != 0:
        raise RuntimeError(f"empty_launch: CUDA error {err}")
