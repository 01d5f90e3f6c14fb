"""LR schedule: the reference's LambdaLinearScheduler.

Counterpart of the JAX package's `training/lr.py`: linear warm-up from
f_start to f_max over warm_up_steps, then linear from f_max to f_min over
the cycle (constant with the shipped f_max = f_min = 1).
"""

from __future__ import annotations

from typing import Callable


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 100,
                           cycle_length: int = 100000, f_start: float = 0.02,
                           f_max: float = 1.0, f_min: float = 1.0) -> Callable[[int], float]:
    """step (optimizer steps taken so far) -> learning rate."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            f = f_start + (f_max - f_start) / warm_up_steps * step
        else:
            f = f_min + (f_max - f_min) * (cycle_length - step) / cycle_length
        return base_lr * f

    return schedule
