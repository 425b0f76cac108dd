"""Pipeline-parallel (GPipe) training of the Performer prior.

Port of ``synthanatomy_tpu/parallel/pipeline_parallel.py`` for one
process per card.  The depth-L block stack is cut into P contiguous
stages, one a rank of the pipe group (``mesh.rank_layout(...,
pp_stages=P)``): stage s runs layers [s·L/P, (s+1)·L/P).  M
microbatches stream through a fill-drain schedule of M + P − 1 ticks:
at forward tick t stage s runs microbatch t − s, then each rank passes
its output to the next stage while it takes its next input from the
previous one (``distributed.pipe_send_recv``, JAX's ``ppermute``).  All
M forwards run first, then the M backwards in reverse order, the
cotangents flowing the other way.  Stage 0 also runs the embeddings
(``Performer.embed``, JAX's ``_embed_method``), the last stage the final
norm, the 'prepending' slice and the head (``Performer.encode`` and
``_head``, JAX's ``_head_method``) and the CE.  The bubble is (P − 1) /
(M + P − 1) of the schedule, as in JAX.

Where the port differs from JAX, by design:

- A stage runs the model's own blocks, with its kernel flags: rows 5 and
  6 run in each stage's layers under ``use_pallas_favor`` /
  ``use_pallas_local``, as in the one-device and TP steps.  JAX's stage
  template switches its Pallas kernels off (``pipeline_parallel.py:65-79``)
  for GSPMD's partitioner, which one process a card does not have.
- JAX differentiates through ``ppermute`` inside one program; here the
  train step runs the drain explicitly, each stage backpropagating its
  microbatches from the cotangents it receives.  Remat is per stage and
  microbatch: only the stage's input is kept, and the stage runs again
  in the backward (``torch.utils.checkpoint``, non-reentrant).
- JAX psum-broadcasts the logits to every device; the train step
  broadcasts only the loss (in the all-reduce of the replicated
  parameters' gradients), :func:`make_pipelined_apply` the logits.

Each rank holds its stage alone: the packed state (:func:`pack_pp_state`)
is a copy of the canonical model that holds the non-block parameters
(embeddings, position and spatial tables, final norm, head) and layers
[lo, hi), the other layers' blocks empty stand-ins (no parameters, no
buffers), with Adam over exactly those parameters under their canonical
names, their moments and step counts.  It is built from a canonical
state that may live on the host (the runner's), so the whole model never
reaches the rank's card.  :func:`unpack_pp_state` gathers the stages'
blocks (parameters, FAVOR projections, Adam's state) over the pipe group
into the canonical state, on every rank (the tests, the dry run) or on
the pipe group's rank 0 alone (``root_only``: the runner's checkpoints,
one tensor at a time into host memory), as
``tensor_parallel.gather_tp_state`` does for TP, so checkpoints stay
canonical; pack and unpack are exact inverses.  The non-block parameters
are replicated: stage 0 holds the embeddings' share of their gradient,
the last stage the head's (a tied embedding gets both), and the shares
are summed over the pipe group before Adam steps, so every rank steps
them alike.  With a data group (PP×DP) every gradient is also averaged
over the data ranks.  The projection redraw is the one-device
``redraw_projections`` on every rank: all L layers are drawn in order,
the other stages' matrices dropped, so the generators stay in step and
each stage's projections are the ones one process draws.

JAX's ``stack_block_params`` and ``pp_param_specs`` are GSPMD placement
(the (L, …) stacked slabs and their ``PartitionSpec``) and have no port:
a stage runs its layers as the model's own modules.

Configurations: as JAX's step, no dropout.  Rotary positions raise
``NotImplementedError("PP step: …")``: JAX's stage applies its blocks
without the rotary table (``pipeline_parallel.py:136``), so its PP step
trains another function than its one-device step
(``tests/test_torch_pp.py``; ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from synthanatomy_tpu_torch.losses.transformer import ce_loss
from synthanatomy_tpu_torch.models.performer import Performer, redraw_projections
from synthanatomy_tpu_torch.parallel import distributed as D
from synthanatomy_tpu_torch.parallel.sharding_rules import adam, placed_copy

__all__ = [
    "PipelinedApply",
    "make_pipelined_apply",
    "make_pp_train_step",
    "pack_pp_state",
    "pack_pp_tree",
    "unpack_pp_state",
    "unpack_pp_tree",
]


def _layers(model: Performer, group) -> Tuple[int, int]:
    """[lo, hi): this rank's layers, one of the group's equal contiguous
    stages of ``model``'s depth."""
    rank, n = D.group_info(group)
    if model.depth % n:
        raise ValueError(f"depth {model.depth} must divide into {n} stages")
    per = model.depth // n
    return rank * per, (rank + 1) * per


def _layer(name: str) -> Optional[int]:
    """The layer of a ``blocks.{i}.…`` entry; None for a non-block one."""
    head, _, rest = name.partition(".")
    return int(rest.partition(".")[0]) if head == "blocks" else None


def pack_pp_tree(model: Performer, tree: Dict[str, torch.Tensor],
                 pipe_group) -> Dict[str, torch.Tensor]:
    """A dict under ``model``'s canonical names (a state dict, gradients)
    → this rank's stage's entries: the non-block ones and its own
    layers', under the same names."""
    lo, hi = _layers(model, pipe_group)
    return {name: t for name, t in tree.items()
            if _layer(name) is None or lo <= _layer(name) < hi}


def unpack_pp_tree(model: Performer, tree: Dict[str, torch.Tensor], pipe_group, *,
                   root_only: bool = False) -> Optional[Dict[str, torch.Tensor]]:
    """Inverse of :func:`pack_pp_tree`: this rank's stage's entries of
    ``tree`` (the rest is ignored) with every other stage's layers,
    gathered over the pipe group, a collective: on every rank, or with
    ``root_only`` on the group's rank 0 alone (the gathered layers in
    host memory; None on the other ranks).  The stages' entries are alike
    past their layer numbers (the blocks are alike); the non-block entries
    are this rank's.  ``model`` is the canonical model or a stage of it."""
    lo, hi = _layers(model, pipe_group)
    mine = pack_pp_tree(model, tree, pipe_group)
    blocks = [name for name in mine if _layer(name) is not None]
    stacks = D.stack_over_ranks([mine[n] for n in blocks], pipe_group, root_only=root_only)
    if stacks is None:
        return None
    out = {name: t for name, t in mine.items() if _layer(name) is None}
    for name, stack in zip(blocks, stacks):
        i, rest = _layer(name) - lo, name.split(".", 2)[2]
        for r, t in enumerate(stack):
            out[f"blocks.{r * (hi - lo) + i}.{rest}"] = t
    return out


def pack_pp_state(model: Performer, state, pipe_group, *, device=None):
    """This rank's packed state from a canonical ``TransformerTrainState``
    of ``model`` (left as it is; it may live on the host): the rank's
    stage, a copy of ``model`` on ``device`` (default: ``model``'s) that
    holds the non-block parameters and buffers and layers [lo, hi), the
    other layers empty stand-ins, with Adam over its parameters
    (:func:`pack_pp_tree`) and their moments and step counts; the
    generators and counters shared."""
    from synthanatomy_tpu_torch.train.transformer_steps import TransformerTrainState

    device = next(model.parameters()).device if device is None else torch.device(device)
    lo, hi = _layers(model, pipe_group)
    kept = pack_pp_tree(model, {**dict(model.named_parameters()),
                                **dict(model.named_buffers())}, pipe_group)
    stage = placed_copy(model, {name: t.detach().to(device, copy=True)
                                for name, t in kept.items()},
                        [f"blocks.{i}" for i in range(model.depth) if not lo <= i < hi])
    stage.set_generator(state.generator)
    full = dict(model.named_parameters())
    opt = adam(stage.parameters(), state.optimizer.param_groups[0]["lr"])
    for name, p in stage.named_parameters():
        st = state.optimizer.state.get(full[name], {})
        if "exp_avg" in st:
            opt.state[p] = {"step": st["step"].clone(),
                            **{k: st[k].to(device, copy=True) for k in ("exp_avg", "exp_avg_sq")}}
    return TransformerTrainState(step=state.step, model=stage, optimizer=opt,
                                 generator=state.generator,
                                 redraw_generator=state.redraw_generator,
                                 steps_since_redraw=state.steps_since_redraw)


@torch.no_grad()
def unpack_pp_state(model: Optional[Performer], packed, state, pipe_group, *,
                    root_only: bool = False):
    """Write the stages in ``packed`` back into the canonical ``state`` of
    ``model`` (parameters and FAVOR projections, Adam's moments and step
    counts, the counters), each tensor on the device of ``model``'s own: a
    collective over ``pipe_group``.  Every rank ends with the canonical
    state, which it returns; with ``root_only`` the group's rank 0 alone
    (the others pass None for ``model`` and ``state`` if they like, send
    their stage and get None)."""
    stage = packed.model
    tree = unpack_pp_tree(stage, stage.state_dict(), pipe_group, root_only=root_only)
    opt = packed.optimizer.state
    have = {name: opt[p] for name, p in stage.named_parameters() if "exp_avg" in opt.get(p, {})}
    got = {key: unpack_pp_tree(stage, {name: st[key] for name, st in have.items()}, pipe_group,
                               root_only=root_only)
           for key in ("step", "exp_avg", "exp_avg_sq")}
    if tree is None:
        return None
    model.load_state_dict(tree)
    params = dict(model.named_parameters())
    for key, moments in got.items():
        for name, t in moments.items():
            dev = t.device if key == "step" else params[name].device
            state.optimizer.state.setdefault(params[name], {})[key] = t.to(dev, copy=True)
    state.step = packed.step
    state.steps_since_redraw = packed.steps_since_redraw
    return state


class PipelinedApply:
    """The fill-drain schedule of one rank's stage of ``model`` over the
    pipe group (:func:`make_pipelined_apply`).  Calling it runs the
    forward alone and returns the logits on every rank; :meth:`fill` and
    :meth:`drain` are the train step's forward and backward."""

    def __init__(self, model: Performer, pipe_group, n_microbatches: Optional[int],
                 data_group):
        self.model, self.group, self.data_group = model, pipe_group, data_group
        self.rank, self.n_stages = D.group_info(pipe_group)
        self.lo, self.hi = _layers(model, pipe_group)
        self.blocks = model.blocks[self.lo:self.hi]
        self.n_mb = n_microbatches or self.n_stages
        # the stream between stages: the embeddings' dtype promoted by the
        # f32 ReZero gains (performer.py's precision notes)
        self.dtype = (torch.promote_types(model.dtype, torch.float32) if model.use_rezero
                      else model.dtype)
        if pipe_group is not None:
            # NCCL: the group's first operation must join all its ranks, and
            # a tick's point-to-point pairs join two
            dist.all_reduce(torch.zeros(1, device=model.token_emb.weight.device),
                            group=pipe_group)

    def microbatch_rows(self, b: int) -> int:
        if b % self.n_mb:
            raise ValueError(f"batch {b} must divide into {self.n_mb} microbatches")
        return b // self.n_mb

    def _stage(self, h: torch.Tensor) -> torch.Tensor:
        """The stage's layers on ``h``; under autograd only ``h`` is kept,
        and the layers run again in the backward."""
        if torch.is_grad_enabled():
            return checkpoint(self.model.apply_blocks, h, self.blocks, use_reentrant=False)
        return self.model.apply_blocks(h, self.blocks)

    def fill(self, xs: Sequence[torch.Tensor],
             conds: Sequence[Optional[Sequence[torch.Tensor]]], head: Callable):
        """The forward of microbatches ``xs`` (token tensors, each with its
        ``conds``): returns each microbatch's (stage input, stage output)
        and, on the last stage, ``head(m, output)`` of each (else None)."""
        s, last, m_count = self.rank, self.rank == self.n_stages - 1, len(xs)
        recs, kept, inbox = [None] * m_count, [None] * m_count, None
        for t in range(m_count + self.n_stages - 1):
            m, out = t - s, None
            if 0 <= m < m_count:
                if s == 0:
                    h = self.model.embed(xs[m], conds[m])
                else:
                    h = inbox.requires_grad_(torch.is_grad_enabled())
                out = self._stage(h)
                if last:
                    kept[m] = head(m, out)
                elif out.dtype != self.dtype:
                    raise RuntimeError(f"stage {s} output is {out.dtype}, the pipe carries "
                                       f"{self.dtype}")
                recs[m] = (h, out)
            if self.group is None:
                continue
            nxt = t + 1 - s
            inbox = None
            if s > 0 and 0 <= nxt < m_count:
                n_pos = xs[nxt].shape[1] + (self.model.n_prepend if conds[nxt] is not None
                                            else 0)
                inbox = torch.empty(xs[nxt].shape[0], n_pos, self.model.dim, dtype=self.dtype,
                                    device=xs[nxt].device)
            D.pipe_send_recv(None if last else out, inbox, self.group)
        return recs, kept

    def drain(self, recs, losses: Sequence[Optional[torch.Tensor]]) -> None:
        """The backward of :meth:`fill`'s microbatches in reverse order: the
        last stage from ``losses``, the others from the cotangents of their
        outputs that the next stage sends."""
        s, last, m_count = self.rank, self.rank == self.n_stages - 1, len(recs)
        inbox = None
        for u in range(m_count + self.n_stages - 1):
            m, grad_in = m_count - 1 - u + (self.n_stages - 1 - s), None
            if 0 <= m < m_count:
                h, out = recs[m]
                if last:
                    losses[m].backward()
                else:
                    torch.autograd.backward(out, inbox)
                grad_in = h.grad if s > 0 else None
                recs[m] = None
            if self.group is None:
                continue
            nxt = m - 1
            inbox = None
            if not last and 0 <= nxt < m_count:
                out = recs[nxt][1]
                inbox = torch.empty(out.shape, dtype=out.dtype, device=out.device)
            D.pipe_send_recv(grad_in, inbox, self.group, backward=True)

    def _conds(self, conditionings, mb: int, device):
        """Each microbatch's conditioning values (None without them)."""
        if conditionings is None:
            return None
        per = [torch.as_tensor(c, device=device).long().split(mb) for c in conditionings]
        return [list(cs) for cs in zip(*per)]

    @torch.no_grad()
    def loss(self, x: torch.Tensor, targets: torch.Tensor,
             conditionings: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The CE of the batch ``x`` (B, n) against ``targets``, the mean of
        its microbatches' CEs, on every rank: the last stage computes it and
        only the loss crosses the pipe group (one all-reduce of a scalar),
        not the logits.  The model runs in eval mode; with one microbatch
        this is the one-device evaluation's CE of the batch."""
        self.model.eval()
        mb = self.microbatch_rows(x.shape[0])
        xs, ys = x.split(mb), targets.split(mb)
        conds = self._conds(conditionings, mb, x.device) or [None] * len(xs)
        _, kept = self.fill(list(xs), conds, lambda m, out: ce_loss(
            self.model._head(self.model.encode(out, conds[m])), ys[m])[0])
        last = self.rank == self.n_stages - 1
        loss = (torch.stack(kept).float().mean().reshape(1) if last
                else torch.zeros(1, device=x.device))
        if self.group is not None:
            dist.all_reduce(loss, group=self.group)
        return loss[0]

    @torch.no_grad()
    def __call__(self, x: torch.Tensor,
                 conditionings: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """x (B, n) tokens → (B, n, num_tokens) logits of the whole batch on
        every rank.  With a data group, each data rank runs its share of
        each microbatch's rows and the logits are assembled over it."""
        b = x.shape[0]
        mb = self.microbatch_rows(b)
        d_rank, d_size = D.group_info(self.data_group)
        if mb % d_size:
            raise ValueError(f"microbatch {mb} must divide over {d_size} data ranks")
        share = mb // d_size
        rows = [slice(m * mb + d_rank * share, m * mb + (d_rank + 1) * share)
                for m in range(self.n_mb)]
        conds = [None if conditionings is None else
                 [torch.as_tensor(c, device=x.device)[r] for c in conditionings] for r in rows]
        _, kept = self.fill([x[r] for r in rows], conds,
                            lambda m, out: self.model._head(self.model.encode(out, conds[m])))
        # zeros but for the last stage's rows: the sums assemble the batch
        logits = torch.zeros(b, x.shape[1], self.model.num_tokens, device=x.device)
        if self.rank == self.n_stages - 1:
            for r, part in zip(rows, kept):
                logits[r] = part.float()
        for group in (self.group, self.data_group):
            if group is not None:
                dist.all_reduce(logits, group=group)
        return logits.to(self.model.dtype)


def make_pipelined_apply(model: Performer, pipe_group, *, n_microbatches: Optional[int] = None,
                         data_group=None) -> PipelinedApply:
    """``apply(x, conditionings=None) -> logits``: the forward of
    ``model``'s prior (the canonical model, or this rank's stage from
    :func:`pack_pp_state`) pipelined over ``pipe_group``, x the whole batch
    on every rank; ``apply.loss(x, targets, conditionings)`` is the
    batch's CE without gathering the logits.  The batch must divide into
    ``n_microbatches`` (default: the pipe size), each microbatch over
    ``data_group``'s ranks when given (PP×DP: each data rank runs the
    schedule on its rows of every microbatch).  Raises ``ValueError`` when
    the depth does not divide into the stages or the batch into the
    microbatches, as JAX does.  The forward only: gradients are
    :func:`make_pp_train_step`'s."""
    return PipelinedApply(model, pipe_group, n_microbatches, data_group)


def make_pp_train_step(model: Performer, pipe_group, *, data_group=None,
                       n_microbatches: Optional[int] = None) -> Callable:
    """``step(state, inputs, targets, conditionings, sched) -> (state,
    metrics)`` with ``state`` from :func:`pack_pp_state` over
    ``pipe_group`` and ``model`` its stage (``state.model``): the GPipe
    schedule of :func:`make_pipelined_apply`, then the drain, the
    replicated parameters' gradients summed over the pipe group (the loss
    rides along, so every rank reports it), every gradient averaged over
    ``data_group`` when given, Adam and the projection redraw.
    ``inputs``/``targets`` (B, L) are this data group's rows, the same on
    every rank of the pipe group; the loss is the mean of the M
    microbatch CEs, the whole batch's CE.  Raises ``NotImplementedError``
    for dropout (JAX's message) and for a configuration JAX's PP step
    trains differently from its one-device step (rotary positions)."""
    if any(m.rate for m in model.modules() if hasattr(m, "rate")):
        raise NotImplementedError("PP training runs the blocks deterministically; dropout "
                                  "(emb/ff/attn) is unsupported — use DP or single-device")
    if model.rotary_position_emb:
        raise NotImplementedError("PP step: rotary position embeddings (JAX's stage applies "
                                  "its blocks without the rotary table; ROADMAP.md §3)")
    pipe = PipelinedApply(model, pipe_group, n_microbatches, None)
    params = pack_pp_tree(model, dict(model.named_parameters()), pipe_group)
    replicated = [p for name, p in params.items() if _layer(name) is None]
    n_cond = len(model.conditioning_num_tokens)
    interval = model.feature_redraw_interval

    def step(state, inputs, targets, conditionings: Optional[Sequence[torch.Tensor]],
             sched: Dict[str, float]):
        if state.model is not model:
            raise ValueError("the PP step was made for another model: make it for the packed "
                             "state's stage, pack_pp_state(...).model")
        if n_cond and conditionings is None:
            raise ValueError("model was built with conditioning_num_tokens; the PP step needs "
                             "the conditioning values")
        mb = pipe.microbatch_rows(inputs.shape[0])
        xs, ys = inputs.split(mb), targets.split(mb)
        conds = (pipe._conds(conditionings[:n_cond], mb, inputs.device) if n_cond
                 else [None] * len(xs))
        model.train()
        state.optimizer.zero_grad(set_to_none=True)

        def head(m, out):
            logits = model._head(model.encode(out, conds[m]))
            return ce_loss(logits, ys[m])[0] / len(xs)

        recs, losses = pipe.fill(xs, conds, head)
        pipe.drain(recs, losses)
        last = pipe.rank == pipe.n_stages - 1
        loss = (torch.stack([x.detach() for x in losses]).sum().reshape(1) if last
                else torch.zeros(1, device=inputs.device))
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        D.sum_([p.grad for p in replicated] + [loss], pipe_group)
        D.average_gradients(params.values(), data_group)
        for group in state.optimizer.param_groups:
            group["lr"] = float(sched["lr"])
        state.optimizer.step()
        state.step += 1
        state.steps_since_redraw += 1
        if interval and state.steps_since_redraw >= interval:
            redraw_projections(model, state.redraw_generator)
            state.steps_since_redraw = 0
        return state, D.average_metrics({"Loss": loss[0]}, data_group)

    return step
