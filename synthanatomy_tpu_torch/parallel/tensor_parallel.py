"""Megatron tensor-parallel training of the Performer prior.

Port of ``synthanatomy_tpu/parallel/tensor_parallel.py``.  Each rank of
the model group holds H/P attention heads and 1/P of the FF hidden
width: its share of q/k/v and w1 (column-parallel) and of the
attention's ``to_out`` and w2 (row-parallel); embeddings, norms, the
ReZero gains, w2's bias and the head are replicated.  Its heads are an
ordinary ``PerformerAttention`` of H/P heads, so rows 5 and 6 run on each
rank's heads under the two kernel flags, as in the one-device step.  One
all-reduce after the attention's ``to_out`` and one after w2 restore the
replicated residual stream.

Head packing: the canonical q/k/v layout is [global heads, local heads];
a contiguous split would give one rank only FAVOR heads.
:func:`pack_tp_params` permutes the head blocks to [g₀ l₀ | g₁ l₁ | …]
so that every rank holds gh/P FAVOR and lh/P local heads;
:func:`unpack_tp_params` is its exact inverse, so checkpoints stay
canonical.  Adam's moments are permuted and split like the parameters
(each rank's Adam steps its own share).

Gradients flow through Megatron's conjugate operators: ``f`` all-reduces
forward and is the identity backward (it closes a column/row-parallel
pair), ``g`` is the identity forward and all-reduces backward (it opens
one), so the replicated parameters get the same whole gradient on every
rank.  w2's bias and the ReZero gains act after ``f``.  With a data
group (the DP×TP layout) the gradients are also averaged over the data
ranks; JAX reaches that layout through GSPMD, the port through this
step, with the same numbers.

The TP state (:func:`shard_tp_state`) is a ``TransformerTrainState``
whose model is this rank's share (a copy of the Performer with its
attention at H/P heads and sliced tensors under the canonical names) and
whose optimizer is Adam over it; :func:`gather_tp_state` writes the
shares back into a canonical state on every rank of the group.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from synthanatomy_tpu_torch.models.performer import (
    Performer,
    redraw_projections,
    spatial_lookup_layout,
)
from synthanatomy_tpu_torch.ops.local_attention import rounded
from synthanatomy_tpu_torch.parallel import distributed as D
from synthanatomy_tpu_torch.parallel.sharding_rules import adam, performer_split_dim

__all__ = [
    "gather_tp_grads",
    "gather_tp_state",
    "make_tp_train_step",
    "pack_tp_params",
    "pack_tp_state",
    "shard_tp_state",
    "tp_param_specs",
    "tp_step_compatible",
    "unpack_tp_params",
    "unpack_tp_state",
]

_EPS = 1e-6
_QKV = ("to_q", "to_k", "to_v")


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


def _perm(model: Performer, n_shards: int) -> np.ndarray:
    gh = model.heads - model.local_attn_heads
    lh = model.local_attn_heads
    if gh % n_shards or (lh and lh % n_shards):
        raise ValueError(f"global heads {gh} and local heads {lh} must both divide into "
                         f"{n_shards} TP shards")
    return _head_perm(gh, lh, model.dim_head, n_shards)


def _head_dim(name: str) -> Optional[int]:
    """The dimension of ``name`` that runs over the heads: q/k/v's output
    rows (weight and bias), the attention ``to_out``'s input columns."""
    parts = name.split(".")
    if len(parts) == 5 and parts[0] == "blocks" and parts[2] == "attn":
        if parts[3] in _QKV:
            return 0
        if parts[3] == "to_out" and parts[4] == "weight":
            return 1
    return None


def _permute(model, params: Dict[str, torch.Tensor], n_shards: int, inverse: bool):
    perm = _perm(model, n_shards)
    if inverse:
        perm = np.argsort(perm)
    out = dict(params)
    for name, t in params.items():
        dim = _head_dim(name)
        if dim is not None:
            out[name] = t.index_select(dim, torch.as_tensor(perm, device=t.device))
    return out


def pack_tp_params(model: Performer, params: Dict[str, torch.Tensor],
                   n_shards: int) -> Dict[str, torch.Tensor]:
    """``params`` (a state dict of ``model``'s names) with the attention's
    head blocks permuted so that each of ``n_shards`` contiguous shares
    holds gh/P FAVOR and lh/P local heads; other entries unchanged."""
    return _permute(model, params, n_shards, inverse=False)


def unpack_tp_params(model: Performer, params: Dict[str, torch.Tensor],
                     n_shards: int) -> Dict[str, torch.Tensor]:
    """Exact inverse of :func:`pack_tp_params`."""
    return _permute(model, params, n_shards, inverse=True)


def _permute_state(model, state, n_shards: int, inverse: bool):
    """The head permutation applied in place to the state's parameters
    and to Adam's ``exp_avg``/``exp_avg_sq`` (elementwise, so they
    permute as their parameters do)."""
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
    canonical (reference-convertible) head layout."""
    return _permute_state(model, state, n_shards, inverse=True)


def tp_step_compatible(model: Performer, n_shards: int) -> Tuple[bool, str]:
    """``(ok, reason)``: whether :func:`make_tp_train_step` trains this
    configuration."""
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


def tp_param_specs(params: Sequence[str]) -> Dict[str, Optional[int]]:
    """Name → split dimension of the TP step's parameters and buffers
    (``performer_split_dim``)."""
    return {n: performer_split_dim(n) for n in params}


def _share(t: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """A copy of rank ``rank``'s share of ``t`` (all of it when not split)."""
    share = t if dim is None else t.chunk(n, dim)[rank]
    return share.clone(memory_format=torch.contiguous_format)


def shard_tp_state(model: Performer, state, model_group):
    """This rank's TP state from a canonical ``TransformerTrainState`` of
    ``model`` (left as it is): the model packed and split
    (:func:`tp_param_specs`), Adam over the share with its moments and
    step count split the same way, the generators and counters shared."""
    from synthanatomy_tpu_torch.train.transformer_steps import TransformerTrainState

    rank, n = D.group_info(model_group)
    _perm(model, n)  # the heads must divide
    shard = copy.deepcopy(model)
    specs = tp_param_specs(dict(shard.state_dict()))
    packed = pack_tp_params(model, {k: v.detach() for k, v in model.state_dict().items()}, n)
    for blk in shard.blocks:
        blk.attn.heads //= n
        blk.attn.local_heads //= n
    for name, p in list(shard.named_parameters()):
        owner, attr = _owner(shard, name)
        setattr(owner, attr, torch.nn.Parameter(_share(packed[name], specs[name], rank, n)))
    opt = adam(shard.parameters(), state.optimizer.param_groups[0]["lr"])
    full = dict(model.named_parameters())
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        have = {nm: state.optimizer.state[p][key] for nm, p in full.items()
                if key in state.optimizer.state.get(p, {})}
        moments[key] = pack_tp_params(model, have, n)
    for nm, p in shard.named_parameters():
        st = state.optimizer.state.get(full[nm], {})
        if "exp_avg" in st:
            opt.state[p] = {"step": st["step"].clone(),
                            **{key: _share(moments[key][nm], specs[nm], rank, n)
                               for key in moments}}
    return TransformerTrainState(step=state.step, model=shard, optimizer=opt,
                                 generator=state.generator,
                                 redraw_generator=state.redraw_generator,
                                 steps_since_redraw=state.steps_since_redraw)


def _owner(module: torch.nn.Module, name: str):
    *path, attr = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, attr


def _gather(tensors: Sequence[Tuple[torch.Tensor, Optional[int]]], group):
    """Each (share, dim) concatenated over the ranks of ``group`` along
    ``dim`` (a replicated entry as it is), on every rank, exactly
    (``distributed.stack_over_ranks``)."""
    split = [t for t, d in tensors if d is not None]
    it = iter(D.stack_over_ranks(split, group))
    return [t if d is None else next(it).movedim(0, d).flatten(d, d + 1) for t, d in tensors]


@torch.no_grad()
def gather_tp_state(model: Performer, tp_state, state, model_group):
    """Write the ranks' shares in ``tp_state`` back into the canonical
    ``state`` of ``model`` (parameters, FAVOR projections, Adam's moments
    and step count, the counters), unpacked: a collective over
    ``model_group``; every rank ends with the canonical state."""
    _, n = D.group_info(model_group)
    shard = tp_state.model
    sd = shard.state_dict()
    specs = tp_param_specs(sd)
    names = list(sd)
    got = _gather([(sd[k], specs[k]) for k in names], model_group)
    model.load_state_dict(unpack_tp_params(model, dict(zip(names, got)), n))
    params = dict(model.named_parameters())
    shard_params = dict(shard.named_parameters())
    opt_state = tp_state.optimizer.state
    have = [nm for nm, p in shard_params.items() if "exp_avg" in opt_state.get(p, {})]
    for key in ("exp_avg", "exp_avg_sq"):
        got = _gather([(opt_state[shard_params[nm]][key], specs[nm])
                       for nm in have], model_group)
        for nm, t in unpack_tp_params(model, dict(zip(have, got)), n).items():
            state.optimizer.state.setdefault(params[nm], {})[key] = t.clone()
    for nm in have:
        state.optimizer.state[params[nm]]["step"] = opt_state[shard_params[nm]]["step"].clone()
    state.step = tp_state.step
    state.steps_since_redraw = tp_state.steps_since_redraw
    return state


def gather_tp_grads(model: Performer, tp_state, model_group) -> Dict[str, torch.Tensor]:
    """The gradients of the shares in ``tp_state`` (after a step),
    gathered over ``model_group`` and unpacked: ``model``'s canonical
    names and shapes, on every rank (a collective)."""
    _, n = D.group_info(model_group)
    named = list(tp_state.model.named_parameters())
    specs = tp_param_specs([nm for nm, _ in named])
    got = _gather([(p.grad, specs[nm]) for nm, p in named], model_group)
    return unpack_tp_params(model, dict(zip([nm for nm, _ in named], got)), n)


class _F(torch.autograd.Function):
    """Megatron's ``f``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _G(torch.autograd.Function):
    """Megatron's ``g``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def make_tp_train_step(
    model: Performer,
    model_group,
    *,
    data_group=None,
    use_pallas_local: Optional[bool] = None,
    use_pallas_favor: Optional[bool] = None,
) -> Callable:
    """``step(state, inputs, targets, conditionings, sched) -> (state,
    metrics)`` with ``state`` from :func:`shard_tp_state` over
    ``model_group``.  ``model`` is the canonical Performer (its
    configuration; JAX's module).  The two flags route each rank's heads
    through rows 5 and 6 as the one-device step's (None: ``model``'s own
    flags).  ``inputs``/``targets`` (B, L) are this data group's rows,
    the same on every rank of the model group.

    Forms trained (the JAX step's): pre-LayerNorm or ReZero blocks,
    learned positions, learned 'absolute' spatial tables,
    'bos_replacement' conditioning.  Raises ``NotImplementedError("TP
    step: …")`` for the rest (:func:`tp_step_compatible`)."""
    _, n_sh = D.group_info(model_group)
    ok, why = tp_step_compatible(model, n_sh)
    if not ok:
        raise NotImplementedError(f"TP step: {why}")
    attn0 = model.blocks[0].attn
    flags = {"use_pallas_local": attn0.use_pallas_local if use_pallas_local is None
             else use_pallas_local,
             "use_pallas_favor": attn0.use_pallas_favor if use_pallas_favor is None
             else use_pallas_favor}
    dtype, rezero = model.dtype, model.use_rezero
    n_cond = len(model.conditioning_num_tokens)
    interval = model.feature_redraw_interval
    layouts = {}

    def f_op(x):
        return _F.apply(x, model_group) if n_sh > 1 else x

    def g_op(x):
        return _G.apply(x, model_group) if n_sh > 1 else x

    def ln(x, norm):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        return ((x32 - mu) * torch.rsqrt(var + _EPS) * norm.weight + norm.bias).to(x.dtype)

    def loss_fn(shard, inputs, targets, conds):
        h = shard.token_emb.weight.to(dtype)[inputs]
        b, n = inputs.shape
        if shard.spatial_position_emb == "absolute":
            if n not in layouts:
                idx, mask = spatial_lookup_layout(shard._spatial_sequences, n)
                layouts[n] = (torch.from_numpy(idx).long().to(h.device),
                              torch.from_numpy(mask).to(h.device))
            idx, mask = layouts[n]
            for i, emb in enumerate(shard.spatial_embs):
                h = h + (emb.weight.to(dtype)[idx[:, i]] * mask)[None].to(h.dtype)
        if n_cond:
            c0 = torch.zeros(b, 1, model.dim, dtype=dtype, device=h.device)
            for emb, cond in zip(shard.conditioning_embs, conds):
                c0 = c0 + emb.weight.to(dtype)[cond].reshape(b, 1, model.dim)
            h = torch.cat([c0, h[:, 1:]], dim=1)
        h = h + shard.abs_pos_emb.weight.to(dtype)[None, :n]
        for blk in shard.blocks:
            a = f_op(blk.attn(g_op(h.to(dtype) if rezero else ln(h, blk.norm_attn))))
            h = h + (a * blk.g_attn if rezero else a)
            x = g_op(h.to(dtype) if rezero else ln(h, blk.norm_ff))
            w1, w2 = blk.ff.w1, blk.ff.w2
            hid = F.gelu(F.linear(rounded(x, dtype), rounded(w1.weight, dtype)) + w1.bias,
                         approximate="tanh")
            down = F.linear(rounded(hid, dtype), rounded(w2.weight, dtype))
            # w2's bias is replicated: added once, after the sum
            ff = (f_op(down) + w2.bias).to(dtype if rezero else h.dtype)
            h = h + (ff * blk.g_ff if rezero else ff)
        hn = ln(h, shard.final_norm).float()
        if model.tie_embed:
            logits = hn @ shard.token_emb.weight.float().T
        else:
            logits = hn @ shard.to_out.weight.float().T + shard.to_out.bias
        lse = torch.log_softmax(logits, dim=-1)
        return -lse.gather(-1, targets[..., None].long())[..., 0].mean()

    def step(state, inputs, targets, conditionings: Optional[Sequence[torch.Tensor]],
             sched: Dict[str, float]):
        if n_cond and conditionings is None:
            raise ValueError("model was built with conditioning_num_tokens; the TP step needs "
                             "the conditioning values")
        shard = state.model
        for blk in shard.blocks:
            for k, v in flags.items():
                setattr(blk.attn, k, v)
        conds = [torch.as_tensor(c, device=inputs.device).long()
                 for c in (conditionings or ())[:n_cond]]
        shard.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(shard, inputs, targets, conds)
        loss.backward()
        if data_group is not None:
            params = list(shard.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            D.average_gradients(params, data_group)
        for group in state.optimizer.param_groups:
            group["lr"] = float(sched["lr"])
        state.optimizer.step()
        state.step += 1
        state.steps_since_redraw += 1
        if interval and state.steps_since_redraw >= interval:
            redraw_projections(shard, state.redraw_generator)
            state.steps_since_redraw = 0
        return state, D.average_metrics({"Loss": loss.detach()}, data_group)

    return step
