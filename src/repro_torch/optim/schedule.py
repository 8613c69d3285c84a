"""LR schedules (pure functions of the step), in f32 as the reference
computes them (``repro.optim.schedule``)."""
from __future__ import annotations

import math

import numpy as np


def linear_warmup(step, warmup: int, peak: float) -> float:
    s = np.float32(step)
    return float(np.float32(peak) * np.minimum(
        np.float32(1.0), (s + np.float32(1.0)) / np.float32(max(warmup, 1))))


def cosine_schedule(step, warmup: int, total: int, peak: float,
                    floor_frac: float = 0.1) -> float:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac``·peak at ``total``."""
    f = np.float32
    s = f(step)
    if s < warmup:
        return linear_warmup(step, warmup, peak)
    prog = np.clip((s - f(warmup)) / f(max(total - warmup, 1)), f(0), f(1))
    cos = f(peak) * (f(floor_frac) + (f(1) - f(floor_frac)) * f(0.5)
                     * (f(1) + np.cos(f(math.pi) * prog)))
    return float(cos)
