"""FAVOR+ linear attention (Performer), plain PyTorch.

Port of ``synthanatomy_tpu/ops/favor.py``: ``default_nb_features``,
``gaussian_orthogonal_random_matrix``, the softmax-kernel and
generalized feature maps, the chunked causal prefix scan (and the
non-causal form), ``favor_attention`` with JAX's routing: causal
softmax-kernel attention with a projection and the zero key stabilizer
goes to the fused kernel (``ops/favor_attention.py``) when
``use_pallas_scan`` is set; generalized features, ``no_projection``,
non-causal attention and ``stabilize_keys=True`` always take the plain
path here, as they take XLA's in JAX.  ``favor_attention_step`` is the
single-token incremental form of the exact decode path, and
``favor_attention_sequence_parallel`` the form for a shard of the
sequence: each rank's (S, z) totals pass to the later ranks as the
prefix state its scan starts from.

Random draws come from a ``torch.Generator`` and do not reproduce
JAX's bits; weights that must match are carried across by
``interop.performer_from_jax``.  Feature maps and denominators are f32;
products take operands in ``compute_dtype`` and accumulate in f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from synthanatomy_tpu_torch.ops import favor_attention as _fused
from synthanatomy_tpu_torch.ops.local_attention import rounded
from synthanatomy_tpu_torch.parallel.distributed import stack_over_ranks

__all__ = [
    "default_nb_features",
    "gaussian_orthogonal_random_matrix",
    "softmax_kernel_features",
    "generalized_kernel_features",
    "causal_linear_attention_chunked",
    "favor_attention",
    "favor_attention_sequence_parallel",
    "favor_attention_step",
]


def default_nb_features(dim_head: int) -> int:
    """``int(dh · ln dh)`` rounded to a multiple of 128 (256 at dh 64)."""
    raw = int(dim_head * math.log(dim_head))
    return max(128, round(raw / 128) * 128)


def gaussian_orthogonal_random_matrix(
    nb_rows: int,
    nb_cols: int,
    *,
    generator: Optional[torch.Generator] = None,
    scaling: int = 0,
) -> torch.Tensor:
    """(nb_rows, nb_cols) f32 matrix with orthogonal row blocks; rows
    rescaled by chi-distributed norms (scaling=0) or by √nb_cols."""

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    nb_full = nb_rows // nb_cols
    blocks = []
    for _ in range(nb_full):
        q, _ = torch.linalg.qr(normal(nb_cols, nb_cols))
        blocks.append(q.T)
    rem = nb_rows - nb_full * nb_cols
    if rem > 0:
        q, _ = torch.linalg.qr(normal(nb_cols, nb_cols))
        blocks.append(q.T[:rem])
    mat = torch.cat(blocks, dim=0)
    if scaling == 0:
        multiplier = torch.linalg.norm(normal(nb_rows, nb_cols), dim=1)
    elif scaling == 1:
        multiplier = torch.full((nb_rows,), math.sqrt(nb_cols))
    else:
        raise ValueError(f"invalid scaling {scaling}")
    return multiplier[:, None] * mat


def softmax_kernel_features(
    data: torch.Tensor,
    projection: torch.Tensor,
    *,
    is_query: bool,
    eps: float = 1e-4,
    stabilizer: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., L, d) → (..., L, m) f32: m^-1/2 (exp(x·dn·Pᵀ − ‖x‖²dn²/2 −
    stab) + eps).  The query stabilizer is the row max over features
    (``amax``: its gradient splits evenly across ties, as JAX's
    ``reduce_max`` does); the key default is the max over rows and
    features, and an explicit ``stabilizer`` overrides either."""
    data = data.to(torch.float32)
    d = data.shape[-1]
    m = projection.shape[0]
    dn = d ** -0.25
    data_dash = torch.einsum("...id,jd->...ij", dn * data, projection.to(torch.float32))
    diag = (data * data).sum(-1, keepdim=True) / 2.0 * (dn ** 2)
    if stabilizer is None:
        stabilizer = (data_dash.amax(-1, keepdim=True) if is_query
                      else data_dash.amax(dim=(-1, -2), keepdim=True))
    return m ** -0.5 * (torch.exp(data_dash - diag - stabilizer) + eps)


def generalized_kernel_features(
    data: torch.Tensor,
    projection: Optional[torch.Tensor],
    *,
    kernel_fn: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    kernel_eps: float = 1e-3,
) -> torch.Tensor:
    data = data.to(torch.float32)
    dn = data.shape[-1] ** -0.25
    if projection is None:
        return kernel_fn(dn * data) + kernel_eps
    data_dash = torch.einsum("...id,jd->...ij", dn * data, projection.to(torch.float32))
    return kernel_fn(data_dash) + kernel_eps


def _noncausal_linear_attention(q_p, k_p, v, compute_dtype):
    cd = compute_dtype
    k_sum = rounded(k_p, cd).sum(-2)
    d_inv = 1.0 / torch.clamp(
        torch.einsum("...nd,...d->...n", rounded(q_p, cd), k_sum), min=1e-12)
    context = torch.einsum("...nd,...ne->...de", rounded(k_p, cd), rounded(v, cd))
    return torch.einsum("...de,...nd,...n->...ne", context, rounded(q_p, cd), d_inv)


def causal_linear_attention_chunked(
    q_p: torch.Tensor,
    k_p: torch.Tensor,
    v: torch.Tensor,
    chunk: int,
    compute_dtype: torch.dtype = torch.float32,
    init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """q_p/k_p: (B, H, L, m), v: (B, H, L, d) → (B, H, L, d) f32.

    A scan over chunks of ``chunk`` rows carrying S (B, H, m, d) and z
    (B, H, m) in f32, from zeros or from ``init_state`` = (S0, z0) (a
    sequence shard's prefix from the shards before it); within a chunk,
    the lower-triangular score block.
    S and z are rounded to ``compute_dtype`` only where they enter a
    product.  The denominator is clamped at 1e-12, as in JAX.  Rows past
    the last full chunk form a shorter last chunk: JAX pads them with
    zeros, and zero rows after every real row change no real output."""
    cd = compute_dtype
    b, h, n, m = q_p.shape
    if init_state is None:
        S = q_p.new_zeros(b, h, m, v.shape[-1], dtype=torch.float32)
        z = q_p.new_zeros(b, h, m, dtype=torch.float32)
    else:
        S, z = (t.to(torch.float32) for t in init_state)
    outs = []
    for c0 in range(0, n, chunk):
        qi = rounded(q_p[:, :, c0:c0 + chunk], cd)
        ki = rounded(k_p[:, :, c0:c0 + chunk], cd)
        vi = rounded(v[:, :, c0:c0 + chunk], cd)
        c = qi.shape[2]
        tri = torch.tril(torch.ones(c, c, dtype=torch.float32, device=q_p.device))
        scores = torch.einsum("bhim,bhjm->bhij", qi, ki) * tri
        num = (torch.einsum("bhij,bhjd->bhid", rounded(scores, cd), vi)
               + torch.einsum("bhim,bhmd->bhid", qi, rounded(S, cd)))
        den = scores.sum(-1) + torch.einsum("bhim,bhm->bhi", qi, rounded(z, cd))
        outs.append(num / torch.clamp(den, min=1e-12)[..., None])
        S = S + torch.einsum("bhjm,bhjd->bhmd", ki, vi)
        z = z + ki.sum(-2)
    return torch.cat(outs, dim=2)


def favor_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    projection: Optional[torch.Tensor],
    *,
    causal: bool = True,
    generalized: bool = False,
    kernel_fn: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    chunk: int = 128,
    stabilize_keys: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    use_pallas_scan: bool = False,
    pallas_chunk: int = 128,
) -> torch.Tensor:
    """q, k, v: (B, H, L, d) → (B, H, L, d) in v's dtype (see module
    docstring for the routing)."""
    in_dtype = v.dtype
    if (use_pallas_scan and causal and not generalized and projection is not None
            and not stabilize_keys):
        cd = compute_dtype
        out = _fused.favor_attention_fused(
            q.to(cd), k.to(cd), v.to(cd), projection, pallas_chunk)
        return out.to(in_dtype)
    if generalized:
        q_p = generalized_kernel_features(q, projection, kernel_fn=kernel_fn)
        k_p = generalized_kernel_features(k, projection, kernel_fn=kernel_fn)
    elif projection is None:
        # no_projection: q softmaxed over features, k exponentiated
        # (causal) or softmaxed over the sequence (non-causal)
        q_p = torch.softmax(q.to(torch.float32), dim=-1)
        k_p = (torch.exp(k.to(torch.float32)) if causal
               else torch.softmax(k.to(torch.float32), dim=-2))
    else:
        q_p = softmax_kernel_features(q, projection, is_query=True)
        k_stab = None if stabilize_keys else torch.zeros((), device=k.device)
        k_p = softmax_kernel_features(k, projection, is_query=False, stabilizer=k_stab)
    v32 = v.to(torch.float32)
    if causal:
        out = causal_linear_attention_chunked(q_p, k_p, v32, chunk, compute_dtype)
    else:
        out = _noncausal_linear_attention(q_p, k_p, v32, compute_dtype)
    return out.to(in_dtype)


class _StackOverRanks(torch.autograd.Function):
    """(P, *x.shape): every rank's ``x`` in rank order
    (``distributed.stack_over_ranks``).  Backward: each slot's cotangent
    summed over the ranks, the own slot returned (JAX transposes
    ``all_gather`` to a reduce-scatter; gloo has none)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        return stack_over_ranks([x], group)[0]

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank], None


def favor_attention_sequence_parallel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    projection: Optional[torch.Tensor],
    *,
    group,
    generalized: bool = False,
    kernel_fn: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    chunk: int = 128,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Causal FAVOR+ on this rank's shard of the sequence: q, k, v (B, H,
    L/P, d), the ranks of ``group`` holding consecutive shards in rank
    order (None: one shard) → (B, H, L/P, d) in v's dtype.

    The prefix state is associative: each rank reduces its totals S_tot
    (B, H, m, d) and z_tot (B, H, m), one exchange gives every rank all of
    them, the sum over the lower ranks seeds the local chunked scan.  The
    feature maps are :func:`favor_attention`'s causal ones with the key
    stabilizer 0 (a per-shard maximum would differ between shards).
    Equals :func:`favor_attention` on the whole sequence up to rounding."""
    in_dtype = v.dtype
    if generalized:
        q_p = generalized_kernel_features(q, projection, kernel_fn=kernel_fn)
        k_p = generalized_kernel_features(k, projection, kernel_fn=kernel_fn)
    elif projection is None:
        q_p = torch.softmax(q.to(torch.float32), dim=-1)
        k_p = torch.exp(k.to(torch.float32))
    else:
        q_p = softmax_kernel_features(q, projection, is_query=True)
        k_p = softmax_kernel_features(k, projection, is_query=False,
                                      stabilizer=torch.zeros((), device=k.device))
    v32 = v.to(torch.float32)
    init = None
    if group is not None and dist.get_world_size(group) > 1:
        S_tot = torch.einsum("bhjm,bhjd->bhmd", k_p, v32)
        z_tot = k_p.sum(-2)
        rank = dist.get_rank(group)
        all_S = _StackOverRanks.apply(S_tot, group)
        all_z = _StackOverRanks.apply(z_tot, group)
        init = (all_S[:rank].sum(0), all_z[:rank].sum(0))
    out = causal_linear_attention_chunked(q_p, k_p, v32, chunk, compute_dtype, init_state=init)
    return out.to(in_dtype)


def favor_attention_step(
    q_t: torch.Tensor,
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],
    projection: Optional[torch.Tensor],
    *,
    generalized: bool = False,
    kernel_fn: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One causal FAVOR+ token: q_t, k_t, v_t (B, H, d) and the prefix
    state (S (B, H, m, d), z (B, H, m)) → (out_t (B, H, d) in v's dtype,
    state).

    S and z are updated IN PLACE (JAX returns new arrays; in place, the
    state keeps its storage across steps, as the local rings do): they
    accumulate in f32 and are rounded to their own dtype after the
    update, and the output reads the unrounded f32 sums.  The key
    stabilizer is 0, so the step equals the batch path up to that
    cancelled constant and rounding."""
    S, z = state
    if generalized:
        q_p = generalized_kernel_features(q_t[..., None, :], projection, kernel_fn=kernel_fn)
        k_p = generalized_kernel_features(k_t[..., None, :], projection, kernel_fn=kernel_fn)
        q_p, k_p = q_p[..., 0, :], k_p[..., 0, :]
    elif projection is None:
        q_p = torch.softmax(q_t.to(torch.float32), dim=-1)
        k_p = torch.exp(k_t.to(torch.float32))
    else:
        zero = torch.zeros((), device=k_t.device)
        q_p = softmax_kernel_features(q_t[..., None, :], projection, is_query=True)[..., 0, :]
        k_p = softmax_kernel_features(k_t[..., None, :], projection, is_query=False,
                                      stabilizer=zero)[..., 0, :]
    kv = torch.einsum("bhm,bhd->bhmd", k_p, v_t.to(torch.float32))
    if S.dtype == torch.float32:
        S32, z32 = S.add_(kv), z.add_(k_p)
    else:
        S32, z32 = S.to(torch.float32) + kv, z.to(torch.float32) + k_p
        S.copy_(S32)
        z.copy_(z32)
    num = torch.einsum("bhm,bhmd->bhd", q_p, S32)
    den = torch.clamp(torch.einsum("bhm,bhm->bh", q_p, z32), min=1e-12)
    out = num / den[..., None]
    return out.to(v_t.dtype), (S, z)
