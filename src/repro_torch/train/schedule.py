"""Learning-rate schedules (callables of the int step).  Counterpart of
``repro/train/schedule.py``; they return Python floats."""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = float(step)
        if step < warmup_steps:
            return peak * step / max(1, warmup_steps)
        t = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0), 1.0)
        return peak * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))

    return fn


def linear_decay(peak: float, total_steps: int):
    def fn(step):
        t = min(max(float(step) / max(1, total_steps), 0.0), 1.0)
        return peak * (1.0 - t)

    return fn
