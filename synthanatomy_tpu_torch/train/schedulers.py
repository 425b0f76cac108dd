"""Scheduled-parameter calculators.

Host-side pure functions replacing the reference's
``ParamSchedulerHandler`` value calculators
(src/handlers/general.py:18-171) and the LR/decay rules of thumb
(src/utils/general.py:20-72).  Scheduled values are plain Python
floats fed into jitted steps as arguments — no recompilation, no
object mutation.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, List, Union

__all__ = [
    "linear",
    "exponential",
    "step",
    "multistep",
    "get_calculator",
    "get_gamma",
    "get_max_decay_epochs",
    "decay_warmup_step",
    "decay_warmup_linear",
]


def linear(
    initial_value: float,
    step_constant: int,
    step_max_value: int,
    max_value: float,
    current_step: int,
) -> float:
    """Constant until ``step_constant``, then linear toward
    ``max_value`` (reference semantics preserved exactly, including the
    division by ``step_max_value`` rather than the interval length)."""
    if current_step < step_constant:
        delta = initial_value
    elif current_step > step_max_value:
        delta = max_value - initial_value
    else:
        delta = (max_value - initial_value) * (
            (current_step - step_constant) / step_max_value
        )
    return initial_value + delta


def exponential(initial_value: float, gamma: float, current_step: int) -> float:
    return initial_value * gamma**current_step


def step(
    initial_value: float, gamma: float, step_size: int, current_step: int
) -> float:
    return initial_value * gamma ** (current_step // step_size)


def multistep(
    initial_value: float, gamma: float, milestones: List[int], current_step: int
) -> float:
    return initial_value * gamma ** bisect_right(milestones, current_step)


_CALCULATORS = {
    "linear": linear,
    "exponential": exponential,
    "step": step,
    "multistep": multistep,
}


def get_calculator(value_calculator: Union[str, Callable]) -> Callable:
    if callable(value_calculator):
        return value_calculator
    if value_calculator in _CALCULATORS:
        return _CALCULATORS[value_calculator]
    raise ValueError(
        f"value_calculator must be one of {list(_CALCULATORS)} or a Callable."
    )


def get_gamma(
    learning_rate: float,
    epochs: int,
    epoch_length: int = 1,
    *,
    epoch_level: bool = False,
    minimum_lr: float = 1e-5,
) -> float:
    """'auto' gamma: reach ``minimum_lr`` at the end of training
    (reference src/utils/general.py:20-48)."""
    steps = epochs * (1 if epoch_level else epoch_length)
    return math.e ** (math.log(minimum_lr / learning_rate) / steps)


def get_max_decay_epochs(epoch_length: int, batch_size: int) -> int:
    """'auto' max_decay_epochs: EMA sees ≥ 200·437·32 samples before
    reaching decay 0.99 (reference src/utils/general.py:51-72)."""
    rule_of_thumb_samples = 200 * 437 * 32
    return math.ceil(rule_of_thumb_samples / (epoch_length * batch_size))


def decay_warmup_step(
    base_decay: float, max_decay_epochs: int, current_epoch: int
) -> float:
    """Staircase EMA-decay warm-up toward 0.99 in 4 steps (reference
    src/networks/vqvae/configure.py:46-69)."""
    delta = (0.99 - base_decay) / 4
    import numpy as np

    stairs = np.linspace(0, max_decay_epochs, 5)[1:]
    for i in range(4, 0, -1):
        if (current_epoch + 1) >= stairs[i - 1]:
            return base_decay + i * delta
    return base_decay


def decay_warmup_linear(
    base_decay: float, max_decay_epochs: int, current_epoch: int
) -> float:
    """Linear EMA-decay warm-up toward 0.99 (reference
    configure.py:70-90)."""
    return linear(
        initial_value=base_decay,
        step_constant=0,
        step_max_value=max_decay_epochs,
        max_value=0.99,
        current_step=current_epoch,
    )
