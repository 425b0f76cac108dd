"""Stage-2 (Performer prior) train and eval steps.

Port of ``synthanatomy_tpu/train/transformer_steps.py``:
``create_transformer_train_state``, ``make_transformer_train_step``,
``make_transformer_train_step_dp`` and ``make_transformer_eval_step``.
Cross-entropy over next-token logits,
Adam (β 0.9/0.999, eps 1e-8, as ``optax.adam``) with the learning rate
set each step from the scheduled ``sched["lr"]``.  The FAVOR projections
are redrawn from the state's generator every ``feature_redraw_interval``
steps (the JAX runner's loop does this between steps).

The model trains in place: the state holds the module, its optimizer
and the generator that dropout and the redraw draw from.

Data parallelism (``make_transformer_train_step_dp``, JAX's ``shard_map``
step): each rank's gradients, loss and summaries are averaged over the
ranks (f32), so the step equals the one-device step on the ranks'
batches concatenated in rank order.  Dropout draws from each rank's own
generator (``create_transformer_train_state(rank=r)`` folds the rank in,
as JAX folds ``axis_index``); the projection redraw's generator is not
folded, so every rank draws the same projections.  ``zero1=True`` shards
Adam's state over the ranks (``parallel/sharding_rules.py``): the same
numbers, as JAX's GSPMD step under ZeRO-1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from synthanatomy_tpu_torch.losses.transformer import ce_loss
from synthanatomy_tpu_torch.models.performer import Performer, redraw_projections
from synthanatomy_tpu_torch.parallel import distributed as D
from synthanatomy_tpu_torch.parallel.sharding_rules import adam

__all__ = [
    "TransformerTrainState",
    "create_transformer_train_state",
    "make_transformer_train_step",
    "make_transformer_train_step_dp",
    "make_transformer_eval_step",
]


@dataclasses.dataclass
class TransformerTrainState:
    step: int
    model: Performer
    optimizer: torch.optim.Optimizer  # Adam, or Adam behind ZeRO-1
    generator: torch.Generator  # dropout draws (on the model's device)
    redraw_generator: torch.Generator  # projection redraws (CPU: QR on the host)
    steps_since_redraw: int = 0


def create_transformer_train_state(
    model: Performer,
    seed: int,
    *,
    learning_rate: float = 1e-4,
    rank: int = 0,
    zero1: bool = False,
    process_group=None,
    device=None,
) -> TransformerTrainState:
    """Adam over the model's parameters (the FAVOR projections are
    buffers, never trained), sharded over ``process_group`` with
    ``zero1``; the dropout generator seeded from ``seed`` and ``rank``
    (``seed + rank``: the run's per-rank seed; under tensor parallelism
    ``rank`` is the data index, so the ranks of a model group share one
    stream) on ``device`` (default: the model's; the card under TP and
    PP, whose canonical model stays on the host while each rank trains
    its share on the card), the redraw generator from ``seed`` alone,
    equal on every rank."""
    device = next(model.parameters()).device if device is None else torch.device(device)
    optimizer = adam(model.parameters(), learning_rate, zero1=zero1,
                     process_group=process_group)
    generator = torch.Generator(device=device).manual_seed(seed + rank)
    model.set_generator(generator)
    return TransformerTrainState(
        step=0, model=model, optimizer=optimizer, generator=generator,
        redraw_generator=torch.Generator().manual_seed(seed + 1234),
    )


def make_transformer_train_step(model: Performer, *, process_group=None) -> Callable:
    """step(state, inputs, targets, conditionings, sched) → (state,
    metrics).  inputs/targets: (B, L) int tensors (the BOS-shifted pair
    from ``runners.transformer.prepare_batch``); ``sched["lr"]`` is this
    step's learning rate.  The projections are redrawn every
    ``model.feature_redraw_interval`` steps (0: never).  With a
    ``process_group`` the batch is this rank's part of the global batch
    and gradients, loss and summaries are averaged over the ranks."""
    interval = model.feature_redraw_interval

    def step(state: TransformerTrainState, inputs, targets,
             conditionings: Optional[Sequence[torch.Tensor]], sched: Dict[str, float]):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(inputs, conditionings)
        loss, summaries = ce_loss(logits, targets)
        loss.backward()
        D.average_gradients(model.parameters(), process_group)
        for group in state.optimizer.param_groups:
            group["lr"] = float(sched["lr"])
        state.optimizer.step()
        state.step += 1
        state.steps_since_redraw += 1
        if interval and state.steps_since_redraw >= interval:
            redraw_projections(model, state.redraw_generator)
            state.steps_since_redraw = 0
        return state, D.average_metrics({**{k: v.detach() for k, v in summaries.items()},
                                         "Loss": loss.detach()}, process_group)

    return step


def make_transformer_train_step_dp(model: Performer, process_group=None) -> Callable:
    """The data-parallel step (JAX's ``make_transformer_train_step_dp``):
    :func:`make_transformer_train_step` over ``process_group`` (default:
    every rank)."""
    group = D.default_group() if process_group is None else process_group
    if group is None:
        raise ValueError("the data-parallel step needs a process group: launch the ranks "
                         "with torchrun")
    return make_transformer_train_step(model, process_group=group)


def make_transformer_eval_step(model: Performer) -> Callable:
    """step(state, inputs, targets, conditionings) → (logits, metrics),
    without dropout or gradients."""

    @torch.no_grad()
    def step(state: TransformerTrainState, inputs, targets, conditionings=None):
        model.eval()
        logits = model(inputs, conditionings)
        loss, summaries = ce_loss(logits, targets)
        return logits, {**summaries, "Loss": loss}

    return step
