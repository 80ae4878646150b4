"""Baseline configuration policies (paper §VI-A): Random, Greedy, IPA.

Each baseline implements the Controller protocol ``decide(obs) -> Config``,
deciding from the public :class:`~repro_torch.core.controller.Observation`
(predicted load, live config) and the pipeline spec — the same interface the
OPD agent uses. Legacy ``policy(env)`` call sites keep working through the
``ControllerBase`` shim.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from repro_torch.core.controller import ControllerBase, Observation
from repro_torch.core.mdp import (Config, Pipeline, QoSWeights, feasible,
                            pipeline_metrics)


class RandomPolicy(ControllerBase):
    """Uniformly random feasible configuration."""

    def __init__(self, pipe: Pipeline, seed: int = 0):
        self.pipe = pipe
        self.rng = np.random.default_rng(seed)

    def decide(self, obs: Observation) -> Config:
        pipe = self.pipe
        bc = pipe.batch_choices()
        for _ in range(64):
            cfg = Config(
                z=tuple(self.rng.integers(0, len(t.variants)) for t in pipe.tasks),
                f=tuple(self.rng.integers(1, pipe.f_max + 1) for _ in pipe.tasks),
                b=tuple(self.rng.choice(bc) for _ in pipe.tasks),
            )
            if feasible(pipe, cfg):
                return cfg
        return Config(z=tuple(0 for _ in pipe.tasks),
                      f=tuple(1 for _ in pipe.tasks),
                      b=tuple(1 for _ in pipe.tasks))


class GreedyPolicy(ControllerBase):
    """Minimise cost while adhering to resource constraints: cheapest variant
    per stage, minimal replicas/batch to cover the predicted demand."""

    def __init__(self, pipe: Pipeline):
        self.pipe = pipe

    def decide(self, obs: Observation) -> Config:
        pipe = self.pipe
        demand = obs.predicted_load
        bc = pipe.batch_choices()
        z, f, b = [], [], []
        cursor = pipe.topo.cursor()     # placement-aware remaining capacity
        for task in pipe.tasks:
            # cheapest first, fastest (smallest beta) as tie-break — greedy is
            # quality-blind, exactly the paper's "minimise costs" baseline
            zi = int(np.lexsort(([v.beta for v in task.variants],
                                 [v.cost for v in task.variants]))[0])
            var = task.variants[zi]
            best = (1, bc[0])
            found = False
            for fi in range(1, pipe.f_max + 1):
                if not cursor.can_place(var.resource, fi):
                    break
                for bi in bc:
                    if var.throughput(bi, fi) >= demand:
                        best = (fi, bi)
                        found = True
                        break
                if found:
                    break
            fi, bi = best
            cursor.place(var.resource, fi)
            z.append(zi)
            f.append(fi)
            b.append(bi)
        return Config(z=tuple(z), f=tuple(f), b=tuple(b))


class IPAPolicy(ControllerBase):
    """IPA-style solver [Ghafouri et al.]: enumerate variant combinations
    across stages (product space — decision time grows with pipeline
    complexity), solving replicas/batch per stage to meet demand; maximise
    accuracy-first objective. Extended (as in the paper) to respect the
    resource capacity W_max."""

    def __init__(self, pipe: Pipeline, weights: QoSWeights | None = None,
                 accuracy_weight: float = 10.0):
        self.pipe = pipe
        self.w = weights or QoSWeights()
        self.acc_w = accuracy_weight
        self.decision_times: list[float] = []

    def _solve_stage(self, var, demand, cursor, reserve):
        """(f, b) meeting demand for a fixed variant, minimising stage
        latency within the cluster's remaining placeable capacity (leaving
        ``reserve`` for later stages) — IPA overprovisions for QoS headroom
        (the paper: "the most expensive, delivers the highest QoS"), or
        None if the variant cannot meet demand at all."""
        from repro_torch.core.mdp import stage_latency
        best = None
        for fi in range(1, self.pipe.f_max + 1):
            if not cursor.can_place(var.resource, fi, reserve=reserve):
                break
            for bi in self.pipe.batch_choices():
                if var.throughput(bi, fi) >= demand:
                    lat = stage_latency(var, bi, fi, demand)
                    if best is None or lat < best[0]:
                        best = (lat, fi, bi)
        return None if best is None else (best[1], best[2])

    def decide(self, obs: Observation) -> Config:
        t0 = time.perf_counter()
        pipe = self.pipe
        demand = obs.predicted_load
        best_cfg, best_score = None, -np.inf
        variant_ranges = [range(len(t.variants)) for t in pipe.tasks]
        for zs in itertools.product(*variant_ranges):
            f, b, ok = [], [], True
            cursor = pipe.topo.cursor()
            for n, task in enumerate(pipe.tasks):
                var = task.variants[zs[n]]
                # leave an even budget share for the remaining stages
                remaining = pipe.n_tasks - n - 1
                reserve = remaining * min(v.resource for t in pipe.tasks[n + 1:]
                                          for v in t.variants) if remaining else 0.0
                sol = self._solve_stage(var, demand, cursor, reserve)
                if sol is None:
                    ok = False
                    break
                cursor.place(var.resource, sol[0])
                f.append(sol[0])
                b.append(sol[1])
            if not ok:
                continue
            cfg = Config(z=tuple(zs), f=tuple(f), b=tuple(b))
            V, C, T, L, E, _ = pipeline_metrics(pipe, cfg, demand)
            score = self.acc_w * V - self.w.lam * C - L
            if score > best_score:
                best_cfg, best_score = cfg, score
        self.decision_times.append(time.perf_counter() - t0)
        if best_cfg is None:
            return GreedyPolicy(pipe).decide(obs)
        return best_cfg
