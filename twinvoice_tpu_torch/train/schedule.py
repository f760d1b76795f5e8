"""Cosine annealing with warm restarts, per-epoch stepped
(``twinvoice_tpu.train.schedule``, copied).

Matches torch ``CosineAnnealingWarmRestarts(T_0, T_mult)`` stepped once per
epoch: restart periods T_0, T_0·T_mult, T_0·T_mult², …; within a period of
length T_i at position T_cur,

    lr = eta_min + (base_lr − eta_min) · (1 + cos(π·T_cur/T_i)) / 2

The reference steps the scheduler *after* each epoch, so epoch e (1-based)
trains at the schedule value for T_cur = e−1.
"""

from __future__ import annotations

import math


def warm_restart_position(epoch0: int, t0: int, t_mult: int):
    """0-based epoch → (T_cur, T_i) within the restart cycle."""
    if t_mult == 1:
        return epoch0 % t0, t0
    # cycle lengths t0, t0*m, t0*m^2...; find which cycle epoch0 falls in
    n = int(math.log((epoch0 / t0) * (t_mult - 1) + 1, t_mult))
    start = t0 * (t_mult ** n - 1) // (t_mult - 1)
    return epoch0 - start, t0 * t_mult ** n


def cosine_warm_restarts(base_lr: float, t0: int = 10, t_mult: int = 2, eta_min: float = 0.0):
    """Returns epoch0 (0-based) → lr, a plain-python schedule used to feed the
    optimizer one constant lr per epoch (the reference holds lr constant
    within an epoch)."""

    def schedule(epoch0: int) -> float:
        t_cur, t_i = warm_restart_position(int(epoch0), t0, t_mult)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule
