"""Telemetry store for the serving runtime (the Prometheus of the paper's
§III-A monitoring, but per-request): end-to-end latency records with
p50/p95/p99, per-second arrival counts (the predictor's load history), batch
dispatch log, queue depths and per-stage busy-time utilization.

Interval queries (``completed_in`` / ``arrived_in`` / ``latencies``) are
O(log n + window): the event loop records completions in non-decreasing
finish time and arrivals in non-decreasing arrival time, so both live in
sorted parallel arrays sliced with ``bisect`` (an out-of-order record falls
back to an insort, keeping the invariant). ``benchmarks/telemetry_queries.py``
asserts per-query cost stays flat as the record count grows.
"""
from __future__ import annotations

from bisect import bisect_left, insort
from collections import defaultdict
from dataclasses import dataclass

import numpy as np


def percentile(xs: np.ndarray, p: float) -> float:
    """Linear-interpolated percentile, NaN on empty (np.percentile raises)."""
    xs = np.asarray(xs, dtype=np.float64)
    if xs.size == 0:
        return float("nan")
    return float(np.percentile(xs, p))


@dataclass
class BatchRecord:
    stage: int
    time: float          # dispatch time (virtual s)
    size: int            # actual batch size dispatched
    service: float       # charged service time (virtual s)
    queue_depth: int     # depth left behind after the pop


@dataclass
class CompletionRecord:
    rid: int
    arrival: float
    finish: float

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


class Telemetry:
    def __init__(self):
        self.arrival_counts: dict[int, int] = defaultdict(int)  # second -> n
        self.completions: list[CompletionRecord] = []
        self.batches: list[BatchRecord] = []
        self.reconfigs: list[tuple[float, int]] = []  # (time, n_switched)
        # sorted parallel indexes for O(log n) interval queries
        self._arrival_times: list[float] = []
        self._finish_times: list[float] = []
        self._latencies: list[float] = []
        # arrivals rejected by admission control (multi-tenant overload):
        # shed requests count as *offered* load (they are recorded as
        # arrivals) but never enter a queue and never complete
        self._shed_times: list[float] = []

    # -------------------------------------------------------- recording --

    def record_arrival(self, t: float):
        self.arrival_counts[int(t)] += 1
        if self._arrival_times and t < self._arrival_times[-1]:
            insort(self._arrival_times, t)
        else:
            self._arrival_times.append(t)

    def record_completion(self, rid: int, arrival: float, finish: float):
        self.completions.append(CompletionRecord(rid, arrival, finish))
        if self._finish_times and finish < self._finish_times[-1]:
            i = bisect_left(self._finish_times, finish)
            self._finish_times.insert(i, finish)
            self._latencies.insert(i, finish - arrival)
        else:
            self._finish_times.append(finish)
            self._latencies.append(finish - arrival)

    def record_shed(self, t: float):
        if self._shed_times and t < self._shed_times[-1]:
            insort(self._shed_times, t)
        else:
            self._shed_times.append(t)

    def record_batch(self, stage: int, t: float, size: int, service: float,
                     queue_depth: int):
        self.batches.append(BatchRecord(stage, t, size, service, queue_depth))

    def record_reconfig(self, t: float, n_switched: int):
        self.reconfigs.append((t, n_switched))

    # ---------------------------------------------------------- queries --

    def _finish_window(self, t0: float, t1: float) -> tuple[int, int]:
        return (bisect_left(self._finish_times, t0),
                bisect_left(self._finish_times, t1))

    def latencies(self, t0: float = -np.inf, t1: float = np.inf) -> np.ndarray:
        """End-to-end latencies of requests finishing in [t0, t1)."""
        lo, hi = self._finish_window(t0, t1)
        return np.asarray(self._latencies[lo:hi], dtype=np.float64)

    def completed_in(self, t0: float, t1: float) -> int:
        lo, hi = self._finish_window(t0, t1)
        return hi - lo

    def arrived_in(self, t0: float, t1: float) -> int:
        return (bisect_left(self._arrival_times, t1)
                - bisect_left(self._arrival_times, t0))

    def shed_in(self, t0: float, t1: float) -> int:
        return (bisect_left(self._shed_times, t1)
                - bisect_left(self._shed_times, t0))

    @property
    def shed(self) -> int:
        return len(self._shed_times)

    def load_history(self, now: float, history: int = 120) -> np.ndarray:
        """Per-second arrival counts over the last ``history`` seconds —
        what the LSTM workload predictor consumes."""
        end = int(now)
        return np.asarray([self.arrival_counts.get(s, 0)
                           for s in range(end - history, end)],
                          dtype=np.float64)

    def latency_percentiles(self, ps=(50, 95, 99), *, t0: float = -np.inf,
                            t1: float = np.inf) -> dict[str, float]:
        lat = self.latencies(t0, t1)
        return {f"p{p}": percentile(lat, p) for p in ps}

    def mean_batch_size(self, stage: int | None = None) -> float:
        sizes = [b.size for b in self.batches
                 if stage is None or b.stage == stage]
        return float(np.mean(sizes)) if sizes else 0.0

    def queue_depths(self, stage: int) -> np.ndarray:
        return np.asarray([b.queue_depth for b in self.batches
                           if b.stage == stage], dtype=np.float64)

    def summary(self, now: float, *, stage_busy: list[float] | None = None,
                stage_capacity: list[float] | None = None) -> dict:
        """Roll-up of the whole run so far. ``stage_capacity`` = available
        replica-seconds per stage (integrated across reconfigurations).
        Null-safe: with zero completions the latency fields are None (JSON
        null), never NaN — a NaN in a benchmark JSON poisons every ratio
        gate comparison downstream (NaN < x is silently False)."""
        lat = self.latencies()
        pcts = {k: (None if np.isnan(v) else v)
                for k, v in self.latency_percentiles().items()}
        arrived = sum(self.arrival_counts.values())
        out = {
            "served": len(self.completions),
            "arrived": arrived,
            "shed": self.shed,
            "shed_rate": self.shed / max(arrived, 1),
            "throughput_rps": len(self.completions) / max(now, 1e-9),
            "latency_mean_s": float(lat.mean()) if lat.size else None,
            **pcts,
            "mean_batch_size": self.mean_batch_size(),
            "reconfigs": len(self.reconfigs),
        }
        if stage_busy is not None and stage_capacity is not None:
            out["utilization"] = [busy / max(cap, 1e-9)
                                  for busy, cap in zip(stage_busy,
                                                       stage_capacity,
                                                       strict=True)]
        return out
