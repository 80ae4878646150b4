"""Expert optimiser for guided PPO training (Algorithm 2: "Initialize expert
optimizer as expert model ... a_t <- action from expert_model given s_t").

The expert does multi-start coordinate descent on the true reward (Eq. 7)
under the simulator's known physics — per task, scan all (z, f, b) holding
the other tasks fixed, sweeping until no improvement. Starts: the live
config (warm), the min-cost config, and a capacity-first config — single
-start descent gets trapped under high load where several stages must scale
together. Strong, cheap, and distinct from the IPA baseline's accuracy-first
product enumeration.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.controller import ControllerBase, Observation
from repro_torch.core.mdp import Config, Pipeline, QoSWeights, feasible, reward


def capacity_config(pipe: Pipeline, demand: float,
                    prefer: str = "latency") -> Config:
    """Cheapest (z, f, b) per stage whose throughput covers demand, placed
    stage by stage through the shared placement scheduler (on a scalar pool
    this is exactly the legacy remaining-budget loop).

    ``prefer`` breaks ties among equal-cost demand-covering variants:
    ``"latency"`` (default — the expert's capacity start, keeps its
    historical behavior) picks the fastest, ``"accuracy"`` picks the most
    accurate. The accuracy preference is what makes the variant *switch*
    with demand on this pipeline's near-uniform per-replica costs: low load
    is served by accurate slow variants and bursts degrade to fast ones —
    which is what gives the proactive pre-warm slot something to warm."""
    bc = pipe.batch_choices()
    z, f, b = [], [], []
    cursor = pipe.topo.cursor()
    for task in pipe.tasks:
        best = None
        for zi, var in enumerate(task.variants):
            tie = -var.accuracy if prefer == "accuracy" else None
            for fi in range(1, pipe.f_max + 1):
                if not cursor.can_place(var.resource, fi):
                    break
                for bi in bc:
                    if var.throughput(bi, fi) >= demand:
                        key = var.latency(bi) if tie is None else tie
                        cand = (fi * var.cost, key, zi, fi, bi)
                        if best is None or cand < best:
                            best = cand
                        break
        if best is None:
            best = (0, 0, 0, 1, 1)
        _, _, zi, fi, bi = best
        cursor.place(task.variants[zi].resource, fi)
        z.append(zi), f.append(fi), b.append(bi)
    return Config(z=tuple(z), f=tuple(f), b=tuple(b))


class CapacityPolicy(ControllerBase):
    """Demand-matched min-cost controller with adaptive degradation: serve
    the predicted load with the cheapest demand-covering configuration,
    preferring the most accurate variant at equal cost. The cost-first
    counterpart of the reward-descending expert — and the inner controller
    of the headline proactive arm in fig45: its variant choice tracks load
    (so forecasts pre-warm real switches) at a config cost below the flat
    reactive baselines."""

    def __init__(self, pipe: Pipeline):
        self.pipe = pipe

    def decide(self, obs: Observation) -> Config:
        return capacity_config(self.pipe, obs.predicted_load,
                               prefer="accuracy")


class ExpertPolicy(ControllerBase):
    def __init__(self, pipe: Pipeline, weights: QoSWeights | None = None,
                 sweeps: int = 3):
        self.pipe = pipe
        self.w = weights or QoSWeights()
        self.sweeps = sweeps

    # ------------------------------------------------------------ starts --

    def _min_cost_start(self) -> Config:
        pipe = self.pipe
        z = tuple(int(np.argmin([v.cost for v in t.variants]))
                  for t in pipe.tasks)
        return Config(z=z, f=tuple(1 for _ in pipe.tasks),
                      b=tuple(1 for _ in pipe.tasks))

    def _capacity_start(self, demand: float) -> Config:
        return capacity_config(self.pipe, demand)

    # ----------------------------------------------------------- descent --

    def _descend(self, cfg: Config, demand: float) -> tuple[Config, float]:
        pipe = self.pipe
        bc = pipe.batch_choices()
        best_r = reward(pipe, cfg, demand, self.w)
        for _ in range(self.sweeps):
            improved = False
            for n, task in enumerate(pipe.tasks):
                for zi in range(len(task.variants)):
                    for fi in range(1, pipe.f_max + 1):
                        for bi in bc:
                            cand = Config(
                                z=cfg.z[:n] + (zi,) + cfg.z[n + 1:],
                                f=cfg.f[:n] + (fi,) + cfg.f[n + 1:],
                                b=cfg.b[:n] + (bi,) + cfg.b[n + 1:])
                            if not feasible(pipe, cand):
                                continue
                            r = reward(pipe, cand, demand, self.w)
                            if r > best_r:
                                cfg, best_r = cand, r
                                improved = True
            if not improved:
                break
        return cfg, best_r

    def decide(self, obs: Observation) -> Config:
        pipe = self.pipe
        demand = obs.predicted_load
        warm = (obs.config if feasible(pipe, obs.config)
                else self._min_cost_start())
        best_cfg, best_r = None, -np.inf
        for start in (warm, self._min_cost_start(),
                      self._capacity_start(demand)):
            cfg, r = self._descend(start, demand)
            if r > best_r:
                best_cfg, best_r = cfg, r
        return best_cfg
