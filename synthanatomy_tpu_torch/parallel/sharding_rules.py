"""Which dimension of each Performer parameter tensor parallelism
splits, and ZeRO-1: the Adam moments sharded over the data ranks.

Port of ``synthanatomy_tpu/parallel/sharding_rules.py``.  The tensor-
parallel half (:50-126): :func:`performer_split_dim` names, for a
parameter of the port's Performer (torch layout, weight (out, in)), the
dimension split over the model group, by JAX's Megatron rules (the
attention's q/k/v and FF w1 column-parallel into the heads and the
hidden width, ``to_out`` and w2 row-parallel back; biases of the
row-parallel layers, norms, embeddings and the output head replicated);
``parallel/tensor_parallel.tp_param_specs`` is built from it.

The ZeRO-1 half (:129-153), where the moments are a placement annotation
under GSPMD: here ``torch.distributed.optim.ZeroRedundancyOptimizer``
around the port's Adam (β 0.9/0.999, eps 1e-8, as ``optax.adam``), which
keeps each parameter's moments on one rank, updates it there and
broadcasts it.  Its parameter groups carry Adam's own defaults, so a
consolidated state dict is a one-device Adam state dict and the reverse.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, Iterable, Optional, Sequence

import torch

__all__ = ["adam", "full_state_dict", "is_zero1", "performer_split_dim", "placed_copy"]

# (name pattern, split dimension of the torch tensor) — first match wins;
# JAX's P(None, "model") on a (in, out) kernel is the out dimension, 0.
# Anchored to the blocks: the output head (``to_out.*``) is replicated
_PERFORMER_RULES = (
    (re.compile(r"^blocks\.\d+\.attn\.(to_q|to_k|to_v)\.(weight|bias)$"), 0),
    (re.compile(r"^blocks\.\d+\.attn\.to_out\.weight$"), 1),
    (re.compile(r"^blocks\.\d+\.ff\.w1\.(weight|bias)$"), 0),
    (re.compile(r"^blocks\.\d+\.ff\.w2\.weight$"), 1),
)


def performer_split_dim(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` split over the model group, or
    None (replicated)."""
    for rx, dim in _PERFORMER_RULES:
        if rx.match(name):
            return dim
    return None


class _StandIn(torch.nn.Module):
    """Holds the place of a submodule that this rank does not hold: no
    parameters, no buffers."""


def placed_copy(model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                stand_ins: Sequence[str] = ()) -> torch.nn.Module:
    """A copy of ``model`` built around ``tensors`` (name → the tensor the
    copy holds under that name, already where it should live): each
    parameter and buffer of ``model`` is replaced by its entry, and each
    submodule named in ``stand_ins`` by an empty module, whose parameters
    and buffers need no entry.  Nothing else of ``model``'s tensors is
    copied, so a share of a model on the host becomes a share on the card
    without the whole model ever reaching it.  The copy shares ``model``'s
    dropout generators; names stay ``model``'s."""
    memo: Dict[int, Any] = {}
    for name in stand_ins:
        memo[id(model.get_submodule(name))] = _StandIn()
    dropped = tuple(f"{name}." for name in stand_ins)
    for name, p in model.named_parameters():
        if not name.startswith(dropped):
            memo[id(p)] = torch.nn.Parameter(tensors[name], requires_grad=p.requires_grad)
    for name, b in model.named_buffers():
        if not name.startswith(dropped):
            memo[id(b)] = tensors[name]
    for mod in model.modules():
        gen = getattr(mod, "generator", None)
        if isinstance(gen, torch.Generator):
            memo[id(gen)] = gen
    return copy.deepcopy(model, memo)


BETAS, EPS = (0.9, 0.999), 1e-8


def adam(params: Iterable[torch.nn.Parameter], lr: float, *, zero1: bool = False,
         process_group=None) -> torch.optim.Optimizer:
    """Adam over ``params``; with ``zero1`` its state sharded over
    ``process_group``'s ranks."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)
    if not zero1:
        return opt
    if process_group is None:
        raise ValueError("ZeRO-1 shards the optimizer over a process group: launch the ranks "
                         "with torchrun")
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.Adam,
                                   process_group=process_group, **opt.defaults)


def is_zero1(opt: Any) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(opt, ZeroRedundancyOptimizer)


def full_state_dict(opt: torch.optim.Optimizer) -> Optional[Dict[str, Any]]:
    """The optimizer's whole state dict: a ZeRO-1 optimizer's is gathered
    to rank 0 (a collective: every rank calls this) and is None
    elsewhere."""
    if not is_zero1(opt):
        return opt.state_dict()
    opt.consolidate_state_dict(to=0)
    return opt.state_dict() if opt.rank == 0 else None
