"""The general traffic generator: a mix file's parameters give the arrival
times of one segment, and the run's seed the request tokens.

The arrival times come from the mix's own ``arrival_seed``, so every seed of
a run serves the same arrivals and the same batches, and only the tokens and
the weights change with the seed. A copy of the port's generator
(``repro_torch.cluster.workloads.make_trace``, ``repro_torch.serving.arrivals``
and ``ServingRuntime.load``), kept here so that the yardstick does not move
with the program. The harness hands the program's runtime ``Arrivals`` and
checks that the program served exactly these requests.
"""

from __future__ import annotations

import numpy as np

CYCLE_SECONDS = 1200


def rate_trace(kind: str, rate: float, seed: int, seconds: int = CYCLE_SECONDS):
    """Per-second rates [seconds] of a paper regime (Fig. 4)."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds, dtype=np.float64)
    if kind == "steady_low":
        lam = 0.15 * rate + 0.02 * rate * np.sin(2 * np.pi * t / 300)
    elif kind == "steady_high":
        lam = 0.85 * rate + 0.03 * rate * np.sin(2 * np.pi * t / 240)
    elif kind == "fluctuating":
        lam = (
            0.45 * rate
            + 0.30 * rate * np.sin(2 * np.pi * t / 400)
            + 0.10 * rate * np.sin(2 * np.pi * t / 97)
        )
        bursts = rng.random(seconds) < 0.01
        lam = lam + bursts * rng.uniform(0.2, 0.5, seconds) * rate
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    noise = rng.normal(0.0, 0.02 * rate, seconds)
    return np.clip(lam + noise, 1.0, None)


def arrival_times(rates: np.ndarray, horizon: float, seed: int) -> np.ndarray:
    """Sorted arrival times in [0, horizon): Poisson counts per second, each
    arrival placed uniformly inside its second."""
    rng = np.random.default_rng(seed)
    seconds = int(np.ceil(horizon))
    reps = int(np.ceil(seconds / len(rates)))
    lam = np.clip(np.tile(rates, reps)[:seconds], 0.0, None)
    counts = rng.poisson(lam)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.float64)
    base = np.repeat(np.arange(seconds, dtype=np.float64), counts)
    out = np.sort(base + rng.random(total))
    return out[out < horizon]


class Arrivals:
    """One segment's arrivals as the program's runtime takes an arrival
    process: ``generate(horizon)`` gives the times, ``rates`` the per-second
    rates, and ``seed`` is what the runtime draws each request's tokens from
    (``ServingRuntime.load``: ``default_rng(seed + 1)``)."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic, self.seed = traffic, int(seed)
        self._rates = rate_trace(traffic["kind"], traffic["rate"], traffic["arrival_seed"])

    def rates(self, horizon: int) -> np.ndarray:
        return np.tile(self._rates, int(np.ceil(horizon / len(self._rates))))[:horizon]

    def generate(self, horizon: float) -> np.ndarray:
        return arrival_times(self._rates, horizon, self.traffic["arrival_seed"])

    times = generate


def segment(traffic: dict, seed: int, horizon: float | None = None):
    """(arrival times [N], tokens [N, seq_len] int32) of one segment."""
    horizon = traffic["segment_s"] if horizon is None else horizon
    times = Arrivals(traffic, seed).generate(horizon)
    rng = np.random.default_rng(seed + 1)
    seq_len, vocab = traffic["seq_len"], traffic["vocab"]
    tokens = np.stack(
        [rng.integers(1, vocab, size=seq_len).astype(np.int32) for _ in times]
    ) if len(times) else np.zeros((0, seq_len), np.int32)
    return times, tokens
