"""Workload traces (requests/s) — the paper's three regimes (Fig. 4):
steady low, fluctuating, steady high. 1200 s cycles, 1 Hz sampling.
Deterministic per seed (paper: "we fix the seed for all random generators").
"""
from __future__ import annotations

import numpy as np

CYCLE_SECONDS = 1200


def make_trace(kind: str, *, seconds: int = CYCLE_SECONDS, seed: int = 0,
               peak: float = 120.0) -> np.ndarray:
    """Per-second request rate [seconds]."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float64)
    if kind == "steady_low":
        lam = 0.15 * peak + 0.02 * peak * np.sin(2 * np.pi * t / 300)
    elif kind == "steady_high":
        lam = 0.85 * peak + 0.03 * peak * np.sin(2 * np.pi * t / 240)
    elif kind == "fluctuating":
        lam = (0.45 * peak
               + 0.30 * peak * np.sin(2 * np.pi * t / 400)
               + 0.10 * peak * np.sin(2 * np.pi * t / 97))
        # occasional bursts
        bursts = rng.random(seconds) < 0.01
        lam = lam + bursts * rng.uniform(0.2, 0.5, seconds) * peak
    else:
        raise ValueError(f"unknown workload kind {kind!r}")
    noise = rng.normal(0.0, 0.02 * peak, seconds)
    return np.clip(lam + noise, 1.0, None)


WORKLOADS = ("steady_low", "fluctuating", "steady_high")
