"""Learning-rate schedules, as ``repro.optim.schedules``; each returns the
fp32 value the JAX schedule computes, as a Python float."""

from __future__ import annotations

import math

import numpy as np


def make_schedule(cfg):
    """cfg: OptimConfig -> callable step -> lr (float)."""
    name = cfg.schedule
    lr0 = np.float32(cfg.lr)

    if name == "constant":
        return lambda t: float(lr0)

    if name == "inverse_time":
        g = cfg.decay_gamma
        return lambda t: float(lr0 / np.float32(1.0 + g * t))

    if name == "cosine":
        total = max(1, cfg.total_steps)

        def cos(t):
            frac = np.clip(np.float32(t / total), 0.0, 1.0)
            return float(np.float32(0.5 * lr0 * (1.0 + np.cos(np.pi * frac))))
        return cos

    if name == "warmup_cosine":
        warm = max(1, cfg.warmup_steps)
        total = max(warm + 1, cfg.total_steps)

        def wc(t):
            t = np.float32(t)
            if t < warm:
                return float(np.float32(lr0 * t / warm))
            frac = np.clip(np.float32((t - warm) / (total - warm)), 0.0, 1.0)
            return float(np.float32(0.5 * lr0 * (1.0 + np.cos(math.pi * frac))))
        return wc

    raise ValueError(f"unknown schedule {name!r}")
