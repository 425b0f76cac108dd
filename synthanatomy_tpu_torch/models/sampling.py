"""Autoregressive sampling for the stage-2 prior.

Port of ``synthanatomy_tpu/models/sampling.py``: ``top_k_logits``,
``sample_next_index``, ``_grid_from_sequence``,
``combined_position_table``, the exact cached sampler ``sample``, the
fused-engine sampler ``sample_fused``, the reference-shaped
``sample_naive``, ``_fused_ok`` and ``make_sampler`` with its
``fused="auto" | True | False`` engine choice.

- ``sample`` runs ``Performer.decode_step`` once per token: FAVOR prefix
  state and local-head rings, exact in the model's precision; on a card
  the steps replay one captured CUDA graph (``exact_logits_stepper``).
- ``sample_fused`` runs the whole-depth fused step once per token
  (``ops/fused_decode.py``: the CUDA kernel on a card, its plain version
  on the CPU) with int8 or packed-int4 weights and a bf16 FAVOR state;
  the ring write, the final LayerNorm, the head product and the draw are
  plain torch around it, as they are plain XLA around the TPU kernel; on
  a card the steps replay one captured CUDA graph (``fused_logits_stepper``),
  the draw outside it.
- ``sample_naive`` re-runs the full forward over the prefix each step.

``make_dp_sampler`` is the data-parallel sampler: each rank samples its
share of the global batch through ``make_sampler`` (the fused step
wherever it covers the prior) with its rank folded into the generator,
and rank 0 gathers the grids in rank order.  Random draws come from an
explicit ``torch.Generator`` and do not reproduce JAX's streams: parity
is checked with greedy decoding.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.models.performer import _row
from synthanatomy_tpu_torch.ops.fused_decode import (
    FusedDecodeConfig,
    count_graph_replay,
    fused_decode_step,
    init_fused_state,
    pack_fused_params,
    strip_reference_weights,
    supports_fused_decode,
    update_rings,
)
from synthanatomy_tpu_torch.parallel.distributed import (
    default_group,
    fold_in,
    gather_to_rank0,
    group_info,
)

__all__ = [
    "top_k_logits",
    "sample_next_index",
    "sample",
    "exact_logits_stepper",
    "combined_position_table",
    "fused_logits_stepper",
    "sample_fused",
    "sample_naive",
    "make_sampler",
    "make_dp_sampler",
]


def top_k_logits(logits: torch.Tensor, k: Optional[int]) -> torch.Tensor:
    """Mask all but the top-k logits to -inf."""
    if k is None:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, -math.inf, logits)


def sample_next_index(
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    sample: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """logits (B, V) → token ids (B,): temperature, optional top-k, then a
    categorical draw (``sample``) or the argmax."""
    logits = top_k_logits(logits.to(torch.float32) / temperature, top_k)
    if sample:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def _grid_from_sequence(tokens: torch.Tensor, ordering: Ordering) -> torch.Tensor:
    """(B, L) sequence in ordering order → (B, *dims) grid."""
    revert = torch.as_tensor(
        np.asarray(ordering.get_revert_sequence_ordering()), device=tokens.device
    )
    return tokens[:, revert].reshape((tokens.shape[0],) + tuple(ordering.dimensions))


def combined_position_table(model, n: int) -> torch.Tensor:
    """(n, dim) f32 positional + spatial rows added per decoded token."""
    return model.position_table(n)


def _config(model, batch, ring_quant, weight_quant) -> FusedDecodeConfig:
    return FusedDecodeConfig(
        depth=model.depth, batch=batch, dim=model.dim, heads=model.heads,
        dim_head=model.dim_head, local_heads=model.local_attn_heads,
        local_window=model.local_window_size, nb_features=model.nb_features,
        ff_mult=model.ff_mult, ring_quant=ring_quant, use_rezero=model.use_rezero,
        weight_quant=weight_quant,
    )


def _mask_bos_and_draw(logits, bos, temperature, top_k, do_sample, generator):
    logits = logits.to(torch.float32)
    logits[:, bos] = -math.inf  # never emit BOS
    return sample_next_index(logits, temperature=temperature, top_k=top_k, sample=do_sample,
                             generator=generator)


def exact_logits_stepper(
    model,
    *,
    batch: int,
    conditionings: Optional[Sequence[torch.Tensor]] = None,
):
    """The exact engine as ``step(tok (B,), t) -> logits (B, V)`` in the
    model's dtype, steps taken in order from t = 0: ``decode_step`` on a
    cache made here (and primed for 'prepending' conditionings), with t
    as a device scalar.

    On a card, steps t >= 2 replay one CUDA graph of ``decode_step``, the
    counterpart of JAX's jit-compiled scan: eagerly, every token costs
    some 110 small launches per layer, issued one by one from the host.
    Step 0 (BOS, 'bos_replacement') runs eagerly; step 1 runs eagerly on
    the capture stream, to set up its library handles, and the capture
    follows (a capture records kernels and runs none).  On the CPU every
    step runs eagerly."""
    device = model.token_emb.weight.device
    cache = model.init_cache(batch)
    if conditionings is not None and model.conditioning_type == "prepending":
        cache = model.prime_cache(cache, conditionings)
    positions = torch.arange(model.max_seq_len, device=device)

    def eager(tok: torch.Tensor, t: int) -> torch.Tensor:
        # conditionings act at t = 0 only ('prepending' is in the cache)
        return model.decode_step(tok, cache, positions[t], conditionings if t == 0 else None)[0]

    if device.type != "cuda":
        return eager
    stream = torch.cuda.Stream(device)
    static_tok = torch.zeros(batch, dtype=torch.long, device=device)
    static_t = torch.zeros((), dtype=torch.long, device=device)
    graph, out = None, None

    def step(tok: torch.Tensor, t: int) -> torch.Tensor:
        nonlocal graph, out
        if t == 0:
            return eager(tok, t)
        if graph is None:
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                logits = eager(tok, t)
            current.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                out = model.decode_step(static_tok, cache, static_t)[0]
            return logits.clone()
        static_tok.copy_(tok)
        static_t.copy_(positions[t])
        graph.replay()
        return out.clone()

    return step


@torch.no_grad()
def sample(
    model,
    ordering: Ordering,
    *,
    batch: int = 1,
    conditionings: Optional[Sequence[torch.Tensor]] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    do_sample: bool = True,
    generator: Optional[torch.Generator] = None,
    bos_token: Optional[int] = None,
) -> torch.Tensor:
    """Exact cached sampling → (B, *ordering.dimensions) int32 grid on the
    model's device: ``decode_step`` per token (see
    :func:`exact_logits_stepper`), after ``prime_cache`` for 'prepending'
    conditionings."""
    device = model.token_emb.weight.device
    seq_len = int(np.prod(ordering.dimensions))
    bos = model.num_tokens - 1 if bos_token is None else bos_token
    step = exact_logits_stepper(model, batch=batch, conditionings=conditionings)
    tok = torch.full((batch,), bos, dtype=torch.long, device=device)
    tokens = []
    for t in range(seq_len):
        tok = _mask_bos_and_draw(step(tok, t), bos, temperature, top_k, do_sample, generator)
        tokens.append(tok)
    return _grid_from_sequence(torch.stack(tokens, dim=1).to(torch.int32), ordering)


def fused_logits_stepper(
    model,
    *,
    batch: int,
    conditionings: Optional[Sequence[torch.Tensor]] = None,
    ring_quant: bool = False,
    weight_quant: str = "int8",
):
    """The fused engine as ``step(tok (B,), t) -> logits (B, V) f32``,
    steps taken in order from t = 0: each step embeds the token, runs the
    whole-depth fused step, writes the rings and applies the final
    LayerNorm and the head.  Weights are packed (int8 or packed int4)
    once, here; the FAVOR state is bf16, the rings bf16 or int8
    (``ring_quant``).  ``t`` is an int, or a 0-d int64 tensor on the
    model's device.

    On a card, steps t >= 2 replay one CUDA graph of the whole step
    (embedding, positional row, the fused step's 5·L + 1 launches, ring
    write, norm and head), as :func:`exact_logits_stepper` does; the draw
    stays outside.  Step 0 (the conditioning branch) runs eagerly; step 1
    runs eagerly on the capture stream, to warm up, and the capture
    follows.  ``fused_decode_step.launches`` counts each replay as one
    step.  On the CPU every step runs eagerly through the plain version."""
    device = model.token_emb.weight.device
    vocab = model.num_tokens
    cfg = _config(model, batch, ring_quant, weight_quant)
    params = strip_reference_weights(pack_fused_params(model, weight_quant=weight_quant))
    emb_t = model.token_emb.weight.to(torch.bfloat16)
    fn_s = model.final_norm.weight.to(torch.float32)
    fn_b = model.final_norm.bias.to(torch.float32)
    # head product in f32 on bf16-rounded operands (the TPU path's bf16
    # dot with f32 accumulation); TF32 stays off for matmuls by default
    if model.tie_embed:
        head_w = emb_t.to(torch.float32).T
        head_b = torch.zeros(vocab, device=device)
    else:
        head_w = model.to_out.weight.T.to(torch.bfloat16).to(torch.float32)
        head_b = model.to_out.bias.to(torch.float32)
    pos_table = combined_position_table(model, model.max_seq_len)

    cond_sum = None
    if conditionings is not None and model.conditioning_type == "bos_replacement":
        cond_sum = torch.zeros(batch, model.dim, device=device)
        for emb, c in zip(model.conditioning_embs, conditionings):
            cond_sum = cond_sum + emb.weight.to(torch.float32)[
                torch.as_tensor(c, device=device).reshape(batch).long()
            ]
    state = init_fused_state(cfg, device=device)

    def run(emb: torch.Tensor, t) -> torch.Tensor:
        pos = _row(pos_table, t) if isinstance(t, torch.Tensor) else pos_table[t]
        h, _, k_all, v_all = fused_decode_step(params, state, emb + pos, t, cfg)
        update_rings(state, k_all, v_all, t, cfg)
        mu = h.mean(-1, keepdim=True)
        var = (h - mu).square().mean(-1, keepdim=True)
        hn = (h - mu) * torch.rsqrt(var + 1e-6) * fn_s + fn_b
        return hn.to(torch.bfloat16).to(torch.float32) @ head_w + head_b

    def embed(tok: torch.Tensor) -> torch.Tensor:
        return emb_t.index_select(0, tok).to(torch.float32)

    def eager(tok: torch.Tensor, t) -> torch.Tensor:
        if cond_sum is not None and int(t) == 0:
            return run(cond_sum, t)
        return run(embed(tok), t)

    if device.type != "cuda":
        return eager
    stream = torch.cuda.Stream(device)
    static_tok = torch.zeros(batch, dtype=torch.long, device=device)
    static_t = torch.zeros((), dtype=torch.long, device=device)
    positions = torch.arange(model.max_seq_len, device=device)
    captured, out = None, None

    def step(tok: torch.Tensor, t) -> torch.Tensor:
        nonlocal captured, out
        if int(t) == 0:
            return eager(tok, t)
        if captured is None:
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                logits = eager(tok, t)
            current.wait_stream(stream)
            captured = torch.cuda.CUDAGraph()
            with torch.cuda.graph(captured, stream=stream):
                out = run(embed(static_tok), static_t)
            return logits.clone()
        static_tok.copy_(tok)
        static_t.copy_(t if isinstance(t, torch.Tensor) else positions[t])
        captured.replay()
        count_graph_replay()
        return out.clone()

    return step


@torch.no_grad()
def sample_fused(
    model,
    ordering: Ordering,
    *,
    batch: int = 1,
    conditionings: Optional[Sequence[torch.Tensor]] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    do_sample: bool = True,
    generator: Optional[torch.Generator] = None,
    bos_token: Optional[int] = None,
    ring_quant: bool = False,
    weight_quant: str = "int8",
) -> torch.Tensor:
    """Fused-step sampling → (B, *ordering.dimensions) int32 grid, on
    the model's device (see :func:`fused_logits_stepper`)."""
    device = model.token_emb.weight.device
    seq_len = int(np.prod(ordering.dimensions))
    bos = model.num_tokens - 1 if bos_token is None else bos_token
    step = fused_logits_stepper(model, batch=batch, conditionings=conditionings,
                                ring_quant=ring_quant, weight_quant=weight_quant)
    tok = torch.full((batch,), bos, dtype=torch.long, device=device)
    tokens = []
    for t in range(seq_len):
        tok = _mask_bos_and_draw(step(tok, t), bos, temperature, top_k, do_sample, generator)
        tokens.append(tok)
    seq = torch.stack(tokens, dim=1).to(torch.int32)
    return _grid_from_sequence(seq, ordering)


@torch.no_grad()
def sample_naive(
    model,
    ordering: Ordering,
    *,
    batch: int = 1,
    conditionings: Optional[Sequence[torch.Tensor]] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    do_sample: bool = True,
    generator: Optional[torch.Generator] = None,
    bos_token: Optional[int] = None,
) -> torch.Tensor:
    """Reference-shaped sampler: the full forward over the whole padded
    prefix each step (O(L) full forwards), kept for parity checks."""
    device = model.token_emb.weight.device
    seq_len = int(np.prod(ordering.dimensions))
    bos = model.num_tokens - 1 if bos_token is None else bos_token
    tokens = torch.full((batch, seq_len + 1), bos, dtype=torch.long, device=device)
    for t in range(seq_len):
        logits = model(tokens[:, :-1], conditionings)[:, t]
        tokens[:, t + 1] = _mask_bos_and_draw(logits, bos, temperature, top_k, do_sample,
                                              generator)
    return _grid_from_sequence(tokens[:, 1:].to(torch.int32), ordering)


def _fused_ok(model, with_conditionings: bool) -> bool:
    if not supports_fused_decode(model):
        return False
    if with_conditionings and model.conditioning_type != "bos_replacement":
        return False  # 'prepending' needs prime_cache on the exact path
    return True


def make_sampler(
    model,
    ordering: Ordering,
    *,
    batch: int = 1,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    do_sample: bool = True,
    bos_token: Optional[int] = None,
    with_conditionings: bool = False,
    fused="auto",
    ring_quant: bool = False,
    weight_quant: str = "int8",
):
    """Return ``sampler(generator=None[, conditionings])``.

    ``fused`` picks the engine: ``"auto"`` takes the fused step
    (quantized weights, bf16 FAVOR state) where ``_fused_ok`` holds and
    the exact :func:`sample` elsewhere; ``True`` demands the fused step
    and raises ``ValueError`` for a configuration it does not cover;
    ``False`` takes the exact path."""
    if fused == "auto":
        use_fused = _fused_ok(model, with_conditionings)
    elif fused:
        if not _fused_ok(model, with_conditionings):
            raise ValueError("fused=True: the fused decode step does not cover this prior "
                             "configuration; use fused='auto' or fused=False")
        use_fused = True
    else:
        use_fused = False
    extra = dict(ring_quant=ring_quant, weight_quant=weight_quant) if use_fused else {}
    engine = sample_fused if use_fused else sample

    def sampler(generator=None, conditionings=None):
        if with_conditionings and conditionings is None:
            raise ValueError("sampler built with with_conditionings=True needs conditionings")
        if not with_conditionings and conditionings is not None:
            raise ValueError(
                "conditionings passed to a sampler built with "
                "with_conditionings=False would be ignored"
            )
        return engine(
            model, ordering, batch=batch, conditionings=conditionings,
            temperature=temperature, top_k=top_k, do_sample=do_sample,
            generator=generator, bos_token=bos_token, **extra,
        )

    sampler.fused = use_fused
    return sampler


def make_dp_sampler(
    model,
    ordering: Ordering,
    *,
    global_batch: int,
    process_group=None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    do_sample: bool = True,
    bos_token: Optional[int] = None,
    with_conditionings: bool = False,
    fused="auto",
    ring_quant: bool = False,
    weight_quant: str = "int8",
):
    """Data-parallel sampler (JAX's ``make_dp_sampler``):
    ``sampler(generator=None[, conditionings])`` on every rank of
    ``process_group`` (default: all).  Each rank runs :func:`make_sampler`
    at ``global_batch // world`` on its rows of the global batch (its
    slice of ``conditionings``, which hold the global batch's values)
    with ``fold_in(generator, rank)``; the grids are gathered to rank 0
    in rank order.  Returns the (global_batch, *grid) int32 grid on rank
    0 and None on the other ranks."""
    group = default_group() if process_group is None else process_group
    rank, world = group_info(group)
    if global_batch % world:
        raise ValueError(f"global_batch {global_batch} must divide over {world} ranks")
    local = global_batch // world
    inner = make_sampler(model, ordering, batch=local, temperature=temperature, top_k=top_k,
                         do_sample=do_sample, bos_token=bos_token,
                         with_conditionings=with_conditionings, fused=fused,
                         ring_quant=ring_quant, weight_quant=weight_quant)

    def sampler(generator=None, conditionings=None):
        if conditionings is not None:
            conditionings = [c[rank * local:(rank + 1) * local] for c in conditionings]
        return gather_to_rank0(inner(fold_in(generator, rank), conditionings), group)

    sampler.fused = inner.fused
    return sampler
