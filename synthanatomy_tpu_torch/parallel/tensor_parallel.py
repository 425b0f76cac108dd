"""Megatron tensor-parallel training of the Performer prior.

Port of ``synthanatomy_tpu/parallel/tensor_parallel.py`` and of the
GSPMD route JAX's runner takes for every other prior form
(``runners/transformer.py:244-262, 488-495`` there).  Each rank of the
model group holds H/P attention heads and 1/P of the FF hidden width:
its share of q/k/v and w1 (column-parallel) and of the attention's
``to_out`` and w2 (row-parallel); embeddings, norms, the ReZero gains,
the row-parallel biases and the head are replicated.  The share is the
Performer itself (a copy under the canonical names) whose attention and
FF modules hold the rank's slices and carry ``tp_group``
(``models/performer.py``): they place Megatron's conjugate operators
around their products (``g`` opens a pair: identity forward, all-reduce
backward; ``f`` closes it: all-reduce forward, identity backward), so
the replicated stream and the replicated parameters' gradients are the
same on every rank.  Everything else is the one-device forward, so the
TP step (:func:`make_tp_train_step`) is the one-device step
(``train/transformer_steps.make_transformer_train_step``) run on the
share: every form it trains (ScaleNorm, GLU, rotary, fixed or axial
positions, 'fixed' spatial tables, 'prepending' conditioning, the
out-bias, dropout, reversible blocks, remat) trains here, and rows 5 and
6 run on each rank's heads under the two kernel flags.

What splits (JAX's rule, ``sharding_rules.py:62-75`` there: an axis that
does not divide stays whole): the attention when its FAVOR and its local
heads both divide by P, else it stays whole on every rank (no
``tp_group``, the same gradient everywhere); the FF when its hidden
width divides, else likewise (:func:`tp_split`).

Dropout: the ranks of a model group draw from one stream (the runner
seeds it by the data index), so the masks in the replicated stream
agree; the FF's hidden dropout draws the whole width's mask and keeps
the rank's columns.  The TP step with dropout is then the one-device
step with the same generator state, which is what JAX's GSPMD step
computes.

Packing: the canonical q/k/v layout is [global heads, local heads]; a
contiguous split would give one rank only FAVOR heads.
:func:`pack_tp_params` permutes the head blocks to [g₀ l₀ | g₁ l₁ | …]
so that every rank holds gh/P FAVOR and lh/P local heads, and under GLU
w1's rows and bias from [a | g] to [a₀ g₀ | a₁ g₁ | …];
:func:`unpack_tp_params` is its exact inverse, so checkpoints stay
canonical.  Adam's moments are permuted and split like the parameters
(each rank's Adam steps its own share).  With a data group (the DP×TP
layout) the gradients are also averaged over the data ranks.

The TP state (:func:`shard_tp_state`) is a ``TransformerTrainState``
whose model is this rank's share and whose optimizer is Adam over it.
The share is built at share size from the packed canonical tensors,
which may live on the host (the runner's), so the whole model never
reaches the rank's card.  :func:`gather_tp_state` writes the shares back
into a canonical state, on every rank of the group (the tests, the dry
run) or on its rank 0 alone (``root_only``: the runner's checkpoints,
one tensor at a time into host memory).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.parallel import distributed as D
from synthanatomy_tpu_torch.parallel.sharding_rules import (
    adam,
    performer_split_dim,
    placed_copy,
)

__all__ = [
    "gather_tp_grads",
    "gather_tp_state",
    "make_tp_train_step",
    "pack_tp_params",
    "pack_tp_state",
    "shard_tp_state",
    "tp_param_specs",
    "tp_split",
    "tp_step_compatible",
    "unpack_tp_params",
    "unpack_tp_state",
]

_QKV = ("to_q", "to_k", "to_v")


def tp_split(model: Performer, n_shards: int) -> Tuple[bool, bool]:
    """(attention, FF): whether each part of ``model``'s blocks splits
    over ``n_shards`` ranks: the attention when its FAVOR and its local
    heads both divide, the FF when its hidden width does; a part that
    does not divide stays whole (JAX's rule)."""
    if n_shards <= 1:
        return False, False
    gh, lh = model.heads - model.local_attn_heads, model.local_attn_heads
    return (gh % n_shards == 0 and lh % n_shards == 0,
            model.dim * model.ff_mult % n_shards == 0)


def _head_perm(gh: int, lh: int, dh: int, n_shards: int) -> np.ndarray:
    """Permutation of the (gh + lh)·dh head columns from the canonical
    [g₀ … g_gh, l₀ … l_lh] order to [g-chunk₀ l-chunk₀ | g-chunk₁ …]."""
    gpp, lpp = gh // n_shards, lh // n_shards
    order = []
    for p in range(n_shards):
        order += list(range(p * gpp, (p + 1) * gpp))
        order += list(range(gh + p * lpp, gh + (p + 1) * lpp))
    idx = np.asarray(order)
    return (idx[:, None] * dh + np.arange(dh)[None, :]).reshape(-1)


def _glu_perm(inner: int, n_shards: int) -> np.ndarray:
    """Permutation of GLU's 2·inner w1 rows from [a | g] to
    [a₀ g₀ | a₁ g₁ | …], so that each contiguous share holds its values'
    gates."""
    w = inner // n_shards
    return np.concatenate([np.r_[p * w:(p + 1) * w, inner + p * w:inner + (p + 1) * w]
                           for p in range(n_shards)])


def _perms(model: Performer, n_shards: int) -> Dict[str, np.ndarray]:
    """The packing's permutations by part ("attn", "ff") of the parts
    that split and need one."""
    attn, ff = tp_split(model, n_shards)
    out = {}
    if attn:
        out["attn"] = _head_perm(model.heads - model.local_attn_heads, model.local_attn_heads,
                                 model.dim_head, n_shards)
    if ff and model.ff_glu:
        out["ff"] = _glu_perm(model.dim * model.ff_mult, n_shards)
    return out


def _permuted_dim(name: str) -> Optional[Tuple[str, int]]:
    """(part, dimension) of the tensors the packing permutes: q/k/v's
    output rows (weight and bias) and the attention ``to_out``'s input
    columns run over the heads, w1's rows and bias over GLU's halves."""
    parts = name.split(".")
    if len(parts) == 5 and parts[0] == "blocks":
        if parts[2] == "attn" and parts[3] in _QKV:
            return "attn", 0
        if parts[2] == "attn" and parts[3] == "to_out" and parts[4] == "weight":
            return "attn", 1
        if parts[2] == "ff" and parts[3] == "w1":
            return "ff", 0
    return None


def _permute(model, params: Dict[str, torch.Tensor], n_shards: int, inverse: bool):
    perms = _perms(model, n_shards)
    if inverse:
        perms = {k: np.argsort(v) for k, v in perms.items()}
    out = dict(params)
    for name, t in params.items():
        where = _permuted_dim(name)
        if where is not None and where[0] in perms:
            out[name] = t.index_select(where[1], torch.as_tensor(perms[where[0]],
                                                                 device=t.device))
    return out


def pack_tp_params(model: Performer, params: Dict[str, torch.Tensor],
                   n_shards: int) -> Dict[str, torch.Tensor]:
    """``params`` (a state dict of ``model``'s names) with the split
    attention's head blocks permuted so that each of ``n_shards``
    contiguous shares holds gh/P FAVOR and lh/P local heads, and a split
    GLU's w1 rows so that each holds its values' gates; other entries
    unchanged."""
    return _permute(model, params, n_shards, inverse=False)


def unpack_tp_params(model: Performer, params: Dict[str, torch.Tensor],
                     n_shards: int) -> Dict[str, torch.Tensor]:
    """Exact inverse of :func:`pack_tp_params`."""
    return _permute(model, params, n_shards, inverse=True)


def _permute_state(model, state, n_shards: int, inverse: bool):
    """The packing applied in place to the state's parameters and to
    Adam's ``exp_avg``/``exp_avg_sq`` (elementwise, so they permute as
    their parameters do)."""
    named = dict(state.model.named_parameters())
    fn = unpack_tp_params if inverse else pack_tp_params
    with torch.no_grad():
        for name, t in fn(model, {n: p.detach() for n, p in named.items()}, n_shards).items():
            named[name].copy_(t)
        for key in ("exp_avg", "exp_avg_sq"):
            moments = {n: state.optimizer.state[p][key] for n, p in named.items()
                       if key in state.optimizer.state.get(p, {})}
            for name, t in fn(model, moments, n_shards).items():
                state.optimizer.state[named[name]][key] = t
    return state


def pack_tp_state(model: Performer, state, n_shards: int):
    """Pack a canonical ``TransformerTrainState`` in place (parameters and
    Adam moments) for the TP step; returns it."""
    return _permute_state(model, state, n_shards, inverse=False)


def unpack_tp_state(model: Performer, state, n_shards: int):
    """Exact inverse of :func:`pack_tp_state`: checkpoints stay in the
    canonical (reference-convertible) layout."""
    return _permute_state(model, state, n_shards, inverse=True)


def tp_step_compatible(model: Performer, n_shards: int) -> Tuple[bool, str]:
    """``(ok, reason)``: whether JAX's manual ``shard_map`` TP step takes
    this configuration (JAX's runner sends the rest through GSPMD).  Kept
    as the port of JAX's public function; nothing in the port's step or
    runner consults it, since :func:`make_tp_train_step` trains every
    form."""
    gh = model.heads - model.local_attn_heads
    lh = model.local_attn_heads
    if gh % n_shards or (lh and lh % n_shards):
        return False, f"heads ({gh} global / {lh} local) not divisible by {n_shards}"
    if model.use_scalenorm:
        return False, "ScaleNorm blocks"
    if model.rotary_position_emb or model.fixed_position_emb or model.axial_position_emb:
        return False, "non-learned positional embedding"
    if model.spatial_position_emb not in (None, "absolute"):
        return False, "'fixed' spatial positional embeddings"
    if model.conditioning_num_tokens and model.conditioning_type != "bos_replacement":
        return False, "'prepending' conditioning"
    if model.attn_out_bias:
        return False, "attn_out_bias"
    if any(m.rate for m in model.modules() if hasattr(m, "rate")):
        return False, "dropout"
    if model.ff_glu:
        return False, "ff_glu"
    if model.reversible:
        return False, "reversible blocks"
    return True, ""


def tp_param_specs(model: Performer, n_shards: int,
                   names: Sequence[str]) -> Dict[str, Optional[int]]:
    """Name → split dimension of the TP share's parameters and buffers:
    ``performer_split_dim``'s Megatron rules for the parts that split
    over ``n_shards`` ranks (:func:`tp_split`), None for the rest."""
    split = dict(zip(("attn", "ff"), tp_split(model, n_shards)))
    out = {}
    for n in names:
        dim = performer_split_dim(n)
        out[n] = dim if dim is not None and split[n.split(".")[2]] else None
    return out


def _share(t: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """A copy of rank ``rank``'s share of ``t`` (all of it when not split)."""
    share = t if dim is None else t.chunk(n, dim)[rank]
    return share.clone(memory_format=torch.contiguous_format)


def shard_tp_state(model: Performer, state, model_group, *, device=None):
    """This rank's TP state from a canonical ``TransformerTrainState`` of
    ``model`` (left as it is; it may live on the host): the share, a copy
    of ``model`` on ``device`` (default: ``model``'s) built around the
    rank's slices of the packed parameters (:func:`tp_param_specs`) and
    the buffers, its split attention and FF modules carrying
    ``model_group``; Adam over the share with its moments and step count
    split the same way; the generators and counters shared (the share's
    dropouts draw from ``state.generator``)."""
    from synthanatomy_tpu_torch.train.transformer_steps import TransformerTrainState

    device = next(model.parameters()).device if device is None else torch.device(device)
    rank, n = D.group_info(model_group)
    split_attn, split_ff = tp_split(model, n)
    full = dict(model.named_parameters())
    specs = tp_param_specs(model, n, list(full))
    packed = pack_tp_params(model, {k: p.detach() for k, p in full.items()}, n)
    shard = placed_copy(model, {
        **{nm: _share(packed[nm], specs[nm], rank, n).to(device) for nm in full},
        **{nm: b.to(device, copy=True) for nm, b in model.named_buffers()}})
    del packed
    shard.set_generator(state.generator)
    for blk in shard.blocks:
        if split_attn:
            blk.attn.heads //= n
            blk.attn.local_heads //= n
            blk.attn.tp_group = model_group
        if split_ff:
            blk.ff.tp_group = model_group
    opt = adam(shard.parameters(), state.optimizer.param_groups[0]["lr"])
    have = {nm: state.optimizer.state[p] for nm, p in full.items()
            if "exp_avg" in state.optimizer.state.get(p, {})}
    moments = {key: pack_tp_params(model, {nm: st[key] for nm, st in have.items()}, n)
               for key in ("exp_avg", "exp_avg_sq")}
    for nm, st in have.items():
        opt.state[shard.get_parameter(nm)] = {
            "step": st["step"].clone(),
            **{key: _share(moments[key][nm], specs[nm], rank, n).to(device) for key in moments}}
    return TransformerTrainState(step=state.step, model=shard, optimizer=opt,
                                 generator=state.generator,
                                 redraw_generator=state.redraw_generator,
                                 steps_since_redraw=state.steps_since_redraw)


def _gather(tensors: Sequence[Tuple[torch.Tensor, Optional[int]]], group, *,
            root_only: bool = False):
    """Each (share, dim) concatenated over the ranks of ``group`` along
    ``dim`` (a replicated entry as it is), exactly
    (``distributed.stack_over_ranks``): on every rank, or with
    ``root_only`` on the group's rank 0 alone, in host memory (None on the
    other ranks)."""
    split = [t for t, d in tensors if d is not None]
    stacks = D.stack_over_ranks(split, group, root_only=root_only)
    if stacks is None:
        return None
    it = iter(stacks)
    return [t if d is None else next(it).movedim(0, d).flatten(d, d + 1) for t, d in tensors]


@torch.no_grad()
def gather_tp_state(model: Optional[Performer], tp_state, state, model_group, *,
                    root_only: bool = False):
    """Write the ranks' shares in ``tp_state`` back into the canonical
    ``state`` of ``model`` (parameters, FAVOR projections, Adam's moments
    and step count, the counters), unpacked, each tensor on the device of
    ``model``'s own: a collective over ``model_group``.  Every rank ends
    with the canonical state, which it returns; with ``root_only`` the
    group's rank 0 alone (the others pass None for ``model`` and
    ``state`` if they like, send their share and get None)."""
    _, n = D.group_info(model_group)
    shard = tp_state.model  # a Performer of the canonical configuration
    sd = shard.state_dict()
    names = list(sd)
    specs = tp_param_specs(shard, n, names)
    got = _gather([(sd[k], specs[k]) for k in names], model_group, root_only=root_only)
    shard_params = dict(shard.named_parameters())
    opt_state = tp_state.optimizer.state
    have = [nm for nm, p in shard_params.items() if "exp_avg" in opt_state.get(p, {})]
    moments = {key: _gather([(opt_state[shard_params[nm]][key], specs[nm]) for nm in have],
                            model_group, root_only=root_only)
               for key in ("exp_avg", "exp_avg_sq")}
    if got is None:
        return None
    model.load_state_dict(unpack_tp_params(shard, dict(zip(names, got)), n))
    params = dict(model.named_parameters())
    for key, ts in moments.items():
        for nm, t in unpack_tp_params(shard, dict(zip(have, ts)), n).items():
            state.optimizer.state.setdefault(params[nm], {})[key] = t.to(params[nm].device,
                                                                         copy=True)
    for nm in have:
        state.optimizer.state[params[nm]]["step"] = opt_state[shard_params[nm]]["step"].clone()
    state.step = tp_state.step
    state.steps_since_redraw = tp_state.steps_since_redraw
    return state


def gather_tp_grads(tp_state, model_group, *,
                    root_only: bool = False) -> Optional[Dict[str, torch.Tensor]]:
    """The gradients of the shares in ``tp_state`` (after a step),
    gathered over ``model_group`` and unpacked: the canonical names and
    shapes, on every rank (a collective), or with ``root_only`` on the
    group's rank 0 alone, in host memory (None on the other ranks)."""
    _, n = D.group_info(model_group)
    shard = tp_state.model
    named = list(shard.named_parameters())
    specs = tp_param_specs(shard, n, [nm for nm, _ in named])
    got = _gather([(p.grad, specs[nm]) for nm, p in named], model_group, root_only=root_only)
    if got is None:
        return None
    return unpack_tp_params(shard, dict(zip([nm for nm, _ in named], got)), n)


def make_tp_train_step(
    share: Performer,
    *,
    data_group=None,
    use_pallas_local: Optional[bool] = None,
    use_pallas_favor: Optional[bool] = None,
) -> Callable:
    """``step(state, inputs, targets, conditionings, sched) -> (state,
    metrics)`` with ``state`` from :func:`shard_tp_state` and ``share``
    its model (``state.model``): the one-device step
    (``make_transformer_train_step``) on the rank's share, its gradients,
    loss and summaries averaged over ``data_group``, built once here.  The
    two flags route each rank's heads through rows 5 and 6 as the
    one-device step's (None: the share's own flags); they are set on the
    share here.  ``inputs``/``targets`` (B, L) are this data group's rows,
    the same on every rank of the model group.  Trains every form the
    one-device step trains."""
    from synthanatomy_tpu_torch.train.transformer_steps import make_transformer_train_step

    for blk in share.blocks:
        for flag, value in (("use_pallas_local", use_pallas_local),
                            ("use_pallas_favor", use_pallas_favor)):
            if value is not None:
                setattr(blk.attn, flag, value)
    n_cond = len(share.conditioning_num_tokens)
    one_device = make_transformer_train_step(share, process_group=data_group)

    def step(state, inputs, targets, conditionings: Optional[Sequence[torch.Tensor]],
             sched: Dict[str, float]):
        if state.model is not share:
            raise ValueError("the TP step was made for another model: make it for the TP "
                             "state's share, shard_tp_state(...).model")
        if n_cond and conditionings is None:
            raise ValueError("model was built with conditioning_num_tokens; the TP step needs "
                             "the conditioning values")
        return one_device(state, inputs, targets, conditionings, sched)

    return step
