"""EMA vector quantization: the codebook state, the nearest-codeword
kernels and their plain twins, and the quantize + EMA update.

Port of ``synthanatomy_tpu/ops/vq.py``.  :class:`VQState` holds the EMA
codebook buffers (f32 whatever the model dtype).  The nearest-codeword
search is ``csrc/vq_argmin.cu`` (TPU kernels ``_vq_argmin_kernel`` :103
and ``_vq_argmin_stats_kernel`` :176): a CUDA tensor launches it or
raises, a CPU tensor takes the plain version (``nearest_codeword_plain``,
``nearest_codeword_stats_plain``).  ``nearest_codeword.launches`` and
``nearest_codeword_stats.launches`` count calls into the library.

:func:`quantize_ema` is an f32 island whatever the compute dtype:
indices from the current codebook, EMA counts and Σx reduced over the
whole batch before the update, Laplace smoothing, commitment loss and
the straight-through estimator, as in JAX.  Where JAX returns a new
``VQState``, the port updates the state's buffers in place under
``no_grad`` and returns the same object.  Its ``process_group`` is JAX's
``axis_name``: the counts and Σx are summed over the ranks (f32
all-reduce) before the update, on either statistics route, so every
rank ends the step with the same codebook; the search stays local.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.distributed as dist
from torch import nn

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK, load_library

__all__ = [
    "FUSED_EMA_STATS",
    "VQState",
    "embed_indices",
    "init_vq_state",
    "nearest_codeword",
    "nearest_codeword_plain",
    "nearest_codeword_stats",
    "nearest_codeword_stats_plain",
    "perplexity",
    "quantize_ema",
]

# take the argmin + EMA-statistics kernel inside quantize_ema (off by
# default, as in JAX)
FUSED_EMA_STATS = False


class VQState(nn.Module):
    """EMA codebook buffers, all f32: ``codebook`` (K, D),
    ``cluster_size`` (K,) and ``embed_avg`` (K, D).  ``init`` is
    ``"normal"`` (N(0, 1)) or ``"kaiming_uniform"`` (U(±√3·√(2/D)))."""

    def __init__(self, num_embeddings: int, embedding_dim: int, init: str = "normal", *,
                 device="cuda", generator: torch.Generator = None):
        super().__init__()
        if init == "normal":
            w = torch.randn(num_embeddings, embedding_dim, generator=generator)
        elif init == "kaiming_uniform":
            bound = math.sqrt(3.0) * math.sqrt(2.0 / embedding_dim)
            w = (torch.rand(num_embeddings, embedding_dim, generator=generator) * 2 - 1) * bound
        else:
            raise ValueError(f"unknown embedding_init {init!r}")
        w = w.to(device)
        self.register_buffer("codebook", w)
        self.register_buffer("cluster_size", torch.zeros(num_embeddings, device=device))
        self.register_buffer("embed_avg", w.clone())


def init_vq_state(num_embeddings: int, embedding_dim: int, init: str = "normal", *,
                  generator: torch.Generator = None, device="cuda") -> VQState:
    """A fresh :class:`VQState` (JAX's ``init_vq_state``)."""
    return VQState(num_embeddings, embedding_dim, init, device=device, generator=generator)


def embed_indices(state: VQState, indices: torch.Tensor) -> torch.Tensor:
    """indices (...,) int → codewords (..., D) f32."""
    return state.codebook[indices.long()]


def perplexity(indices: torch.Tensor, num_embeddings: int, process_group=None) -> torch.Tensor:
    """exp(entropy) of the empirical codeword usage (over every rank's
    indices with a ``process_group``)."""
    counts = torch.bincount(indices.reshape(-1).long(), minlength=num_embeddings).float()
    if process_group is None:
        probs = counts / indices.numel()
    else:
        dist.all_reduce(counts, group=process_group)
        probs = counts / counts.sum()
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def nearest_codeword_plain(x_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ‖w_k‖² − 2·x·w_k in f32 → int32 (N,); ties to the lower
    index.  Needs full-f32 products (``allow_tf32`` off for matmuls, the
    PyTorch default)."""
    x, w = x_flat.float(), codebook.float()
    dist = torch.sum(w * w, dim=1)[None, :] - 2.0 * (x @ w.t())
    return torch.argmin(dist, dim=1).to(torch.int32)


def _onehot_stats(idx, x_flat, k):
    """counts (K,) and Σx (K, D) of the rows that chose each codeword,
    through a one-hot product, as JAX's XLA path forms them"""
    onehot = nn.functional.one_hot(idx.long(), k).float()
    return onehot.sum(0), onehot.t() @ x_flat.float()


def nearest_codeword_stats_plain(x_flat, codebook):
    """→ (indices (N,) int32, counts (K,) f32, Σx (K, D) f32)."""
    idx = nearest_codeword_plain(x_flat, codebook)
    return (idx, *_onehot_stats(idx, x_flat, codebook.shape[0]))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("vq_argmin")
    lib.vq_argmin.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    lib.vq_argmin_stats.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    lib.vq_argmin.restype = lib.vq_argmin_stats.restype = ctypes.c_int
    lib.vq_smem_bytes.argtypes = [ctypes.c_int]
    lib.vq_smem_bytes.restype = ctypes.c_longlong
    lib.vq_max_d.argtypes = []
    lib.vq_max_d.restype = ctypes.c_int
    lib.vq_blocks.argtypes = lib.vq_cluster.argtypes = [ctypes.c_int] * 2
    lib.vq_active_clusters.argtypes = [ctypes.c_int] * 3
    return lib


@functools.lru_cache(maxsize=None)
def _width_ok(d: int) -> bool:
    """The library's route gate for rows of width d (``csrc/vq_plan.h``),
    asked once per width: the launch path makes no query of its own."""
    lib = _lib()
    return 1 <= d <= lib.vq_max_d() and 0 < lib.vq_smem_bytes(d) <= SMEM_PER_BLOCK


def _kernel_inputs(x_flat, codebook):
    if x_flat.device.type != "cuda":
        raise ValueError(f"no nearest-codeword kernel for device {x_flat.device}")
    if x_flat.dim() != 2 or codebook.dim() != 2 or x_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"x {tuple(x_flat.shape)} and codebook {tuple(codebook.shape)} must be "
                         f"(N, D) and (K, D)")
    if codebook.device != x_flat.device:
        raise ValueError(f"codebook on {codebook.device}, x on {x_flat.device}")
    if codebook.dtype != torch.float32:
        raise TypeError(f"the codebook must be f32, got {codebook.dtype}")
    n, d = x_flat.shape
    if not _width_ok(d):
        raise ValueError(f"the nearest-codeword kernel takes 1 <= D <= {_lib().vq_max_d()}, "
                         f"got {d}")
    if codebook.shape[0] < 1 or not 1 <= n < 2 ** 31:
        raise ValueError(f"need K >= 1 and 1 <= N < 2^31, got K {codebook.shape[0]}, N {n}")
    return x_flat.float().contiguous(), codebook.contiguous()


def nearest_codeword(x_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword indices of x (N, D) against the codebook (K, D)
    → int32 (N,).  CUDA tensors launch ``vq_argmin_kernel`` (one cluster
    launch); CPU tensors take :func:`nearest_codeword_plain`."""
    if x_flat.device.type == "cpu":
        return nearest_codeword_plain(x_flat, codebook)
    x, w = _kernel_inputs(x_flat, codebook)
    idx = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    err = _lib().vq_argmin(x.shape[0], w.shape[0], x.shape[1], x.data_ptr(), w.data_ptr(),
                           idx.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin: CUDA error {err}")
    nearest_codeword.launches += 1
    return idx


def nearest_codeword_stats(x_flat: torch.Tensor, codebook: torch.Tensor):
    """Indices plus the EMA statistics → (indices (N,) int32, counts (K,)
    f32, Σx (K, D) f32), with no (N, K) one-hot.  CUDA tensors launch the
    argmin and ``vq_stats_kernel``; CPU tensors take
    :func:`nearest_codeword_stats_plain`."""
    if x_flat.device.type == "cpu":
        return nearest_codeword_stats_plain(x_flat, codebook)
    x, w = _kernel_inputs(x_flat, codebook)
    n, d = x.shape
    k = w.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    counts = torch.empty(k, dtype=torch.float32, device=x.device)
    dw = torch.empty(k, d, dtype=torch.float32, device=x.device)
    err = _lib().vq_argmin_stats(n, k, d, x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                                 counts.data_ptr(), dw.data_ptr(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"vq_argmin_stats: CUDA error {err}")
    nearest_codeword_stats.launches += 1
    return idx, counts, dw


nearest_codeword.launches = 0
nearest_codeword_stats.launches = 0


# ---------------------------------------------------------------------------
# quantize + EMA update
# ---------------------------------------------------------------------------


def quantize_ema(state: VQState, x: torch.Tensor, *, decay, commitment_cost, training: bool,
                 eps: float = 1e-5, plain: bool = False, process_group=None):
    """Quantize x (..., D) with straight-through gradients; when
    ``training``, update the EMA state in place (counts and Σx of the
    whole batch first, summed over ``process_group``'s ranks when one is
    given, then the update).  ``plain`` takes the plain
    nearest-codeword search on any device (JAX's ``use_pallas=False``).  Returns ``(quantized_st (x's
    dtype), commitment_loss (f32), indices (x.shape[:-1], int32),
    state)``; the quantized values come from the codebook before the
    update, as in JAX."""
    in_dtype = x.dtype
    d = x.shape[-1]
    k = state.codebook.shape[0]
    xf = x.float()
    flat = xf.reshape(-1, d).detach()

    if training and FUSED_EMA_STATS and not plain:
        indices, counts, dw = nearest_codeword_stats(flat, state.codebook)
    else:
        search = nearest_codeword_plain if plain else nearest_codeword
        indices = search(flat, state.codebook)
        counts = dw = None
    quantized = embed_indices(state, indices).reshape(xf.shape)

    if training:
        with torch.no_grad():
            if counts is None:
                counts, dw = _onehot_stats(indices, flat, k)
            if process_group is not None:
                # reduce before the update: the global batch's statistics
                stats = torch.cat([counts[:, None], dw], dim=1)
                dist.all_reduce(stats, group=process_group)
                counts, dw = stats[:, 0], stats[:, 1:]
            cluster = state.cluster_size * decay + counts * (1.0 - decay)
            avg = state.embed_avg * decay + dw * (1.0 - decay)
            n_total = cluster.sum()
            smoothed = (cluster + eps) / (n_total + k * eps) * n_total  # Laplace
            state.codebook.copy_(avg / smoothed[:, None])
            state.cluster_size.copy_(cluster)
            state.embed_avg.copy_(avg)

    loss = commitment_cost * torch.mean(torch.square(quantized.detach() - xf))
    quantized_st = xf + (quantized - xf).detach()  # straight-through
    return quantized_st.to(in_dtype), loss, indices.reshape(x.shape[:-1]), state
