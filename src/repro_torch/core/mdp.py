"""The paper's problem model (§III): pipeline, metrics, QoS, objective.

A pipeline is a chain of tasks; each task n has a set of model variants Z_n.
A configuration assigns every task a (variant index z, replicas f, batch b).

Metrics (paper equations):
  Eq. (1)  V = Σ_n v_n(z_n)                      pipeline accuracy
  Eq. (2)  C = Σ_n f_n · c_n(z_n)                 cost (chips, was CPU cores)
  Eq. (3)  Q = α·V + β·T − L − γ·E⁺ / − δ·(−E)⁻   QoS
  Eq. (4)  max  Q − λ·C   s.t. bounds + Σ w_n(z_n)·f_n ≤ W_max
  Eq. (7)  r = Q − β_c·C − γ_b·B                  RL reward

The resource constraint has two regimes. With no explicit cluster topology
(``Pipeline.topology is None``, or a single unit-speed node) the cluster is
the paper's scalar pool: Σ w_n(z_n)·f_n ≤ W_max, and every formula below is
bit-for-bit the historical behaviour. With a heterogeneous
``cluster.topology.ClusterTopology``, feasibility and physics become
*placement-aware*: replicas are bin-packed onto nodes by the deterministic
first-fit scheduler, node speed factors scale each stage's service latency
and throughput, and adjacent stages whose primary nodes differ pay the
topology's cross-node hop latency.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:                       # core must not import cluster at
    from repro_torch.cluster.topology import ClusterTopology, Placement  # runtime

ADAPTATION_INTERVAL = 10          # seconds between decisions (paper §VI-B)
COLD_START_FRACTION = 0.3         # capacity lost in the interval after a switch


@dataclass(frozen=True)
class ModelVariant:
    """One servable model variant for a pipeline task.

    latency(b) = alpha + beta * b   (seconds, batch-linear serving model)
    throughput at batch b with f replicas = f * b / latency(b)
    """
    name: str
    accuracy: float          # v_n(z)  in [0, 1]
    cost: float              # c_n(z)  chips per replica
    resource: float          # w_n(z)  resource units per replica (== cost here)
    alpha: float             # fixed per-batch latency (s)
    beta: float              # per-item latency slope (s)

    def latency(self, batch: int) -> float:
        return self.alpha + self.beta * batch

    def throughput(self, batch: int, replicas: int) -> float:
        return replicas * batch / self.latency(batch)


@dataclass(frozen=True)
class Task:
    name: str
    variants: tuple[ModelVariant, ...]


@dataclass(frozen=True)
class Pipeline:
    name: str
    tasks: tuple[Task, ...]
    f_max: int = 8
    b_max: int = 32
    w_max: float = 64.0      # total device resource capacity W_max
    # None = the legacy homogeneous scalar pool of capacity w_max
    topology: ClusterTopology | None = field(default=None)

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def scalar_pool(self) -> bool:
        """True when resources behave as the paper's single scalar pool
        (no topology, or a trivial single-node unit-speed one)."""
        return self.topology is None or self.topology.trivial

    @property
    def topo(self) -> ClusterTopology:
        """The cluster topology, materializing the implicit homogeneous
        single-node one when none was declared."""
        if self.topology is not None:
            return self.topology
        from repro_torch.cluster.topology import ClusterTopology
        return ClusterTopology.homogeneous(self.w_max)

    def batch_choices(self) -> list[int]:
        out, b = [], 1
        while b <= self.b_max:
            out.append(b)
            b *= 2
        return out


@dataclass(frozen=True)
class QoSWeights:
    """Eq. (3)/(4)/(7) weighting parameters."""
    alpha: float = 4.0       # accuracy weight
    beta: float = 0.05       # (measured) throughput weight
    gamma: float = 0.08      # unmet-demand penalty (E >= 0)
    delta: float = 0.005     # spare-capacity penalty (E < 0)
    lam: float = 0.12        # cost weight in the objective (Eq. 4)
    beta_c: float = 0.12     # cost weight in the reward (Eq. 7)
    gamma_b: float = 0.02    # batch-size penalty in the reward (Eq. 7)


@dataclass(frozen=True)
class Config:
    """One decision a_t: per-task (variant z, replicas f, batch b)."""
    z: tuple[int, ...]
    f: tuple[int, ...]
    b: tuple[int, ...]

    def as_array(self) -> np.ndarray:
        return np.array([self.z, self.f, self.b], dtype=np.int64).T   # [N, 3]


def stage_latency(var: ModelVariant, b: int, f: int, demand: float, *,
                  speed_sum: float | None = None,
                  min_speed: float = 1.0) -> float:
    """End-to-end stage latency: batch-assembly wait (time to fill a batch of
    b at arrival rate demand/f per replica) + queue-aware service time
    (M/M/1-style 1/(1-ρ) inflation as utilisation approaches capacity).

    Placement-aware form: ``speed_sum`` (Σ node speed over the stage's
    replicas) replaces the plain replica count in the throughput term, and
    ``min_speed`` (the slowest node hosting a replica) stretches the service
    time — the slowest device dominates the tail. The defaults reproduce the
    homogeneous arithmetic exactly."""
    service = var.latency(b) / min_speed
    wait = min(b * f / max(demand, 1e-6), 2.0)
    if speed_sum is None:
        thr = var.throughput(b, f)
    else:
        thr = speed_sum * b / var.latency(b)
    rho = demand / max(thr, 1e-9)
    congestion = 1.0 / max(1.0 - rho, 0.1)
    return wait + service * congestion


def placement_for(pipe: Pipeline, cfg: Config) -> Placement:
    """The deterministic placement of ``cfg``'s replicas on the pipeline's
    cluster topology (memoized per (topology, resources, replicas))."""
    res = tuple(task.variants[cfg.z[n]].resource
                for n, task in enumerate(pipe.tasks))
    return pipe.topo.place(res, cfg.f)


def pipeline_metrics(pipe: Pipeline, cfg: Config, demand: float,
                     *, cold_frac: float = 0.0):
    """(V, C, T_meas, L, E, capacity) under ``demand`` req/s.

    capacity = min stage capacity (paper: min throughput across tasks);
    T_meas   = measured pipeline throughput = min(capacity, demand) — what a
               Prometheus monitor reports; used in the QoS (Eq. 3) T term;
    E        = demand - capacity (positive -> unmet load, negative -> spare);
    cold_frac degrades capacity (variant-switch cold start).

    On a heterogeneous topology the stage physics are placement-aware: node
    speed factors scale service latency and throughput, and each adjacent
    stage pair whose primary nodes differ adds ``topo.hop_latency`` to L.
    """
    V = C = L = 0.0
    capacity = float("inf")
    if pipe.scalar_pool:
        for n, task in enumerate(pipe.tasks):
            var = task.variants[cfg.z[n]]
            f, b = cfg.f[n], cfg.b[n]
            V += var.accuracy
            C += f * var.cost
            L += stage_latency(var, b, f, demand)
            capacity = min(capacity, var.throughput(b, f))
    else:
        pl = placement_for(pipe, cfg)
        for n, task in enumerate(pipe.tasks):
            var = task.variants[cfg.z[n]]
            f, b = cfg.f[n], cfg.b[n]
            V += var.accuracy
            C += f * var.cost
            L += stage_latency(var, b, f, demand,
                               speed_sum=pl.stage_speed_sum[n],
                               min_speed=pl.stage_min_speed[n])
            capacity = min(capacity,
                           pl.stage_speed_sum[n] * b / var.latency(b))
        L += pipe.topo.hop_latency * pl.n_hops
    capacity *= (1.0 - cold_frac)
    E = demand - capacity
    T_meas = min(demand, capacity)
    return V, C, T_meas, L, E, capacity


def analytic_pipeline_latency(pipe: Pipeline, cfg: Config,
                              demand: float) -> float:
    """Closed-form end-to-end latency of the pipeline (the L term of
    ``pipeline_metrics`` alone) — the runtime env's smooth fallback when an
    interval completes no requests."""
    if pipe.scalar_pool:
        return sum(stage_latency(task.variants[cfg.z[n]], cfg.b[n], cfg.f[n],
                                 demand)
                   for n, task in enumerate(pipe.tasks))
    pl = placement_for(pipe, cfg)
    L = sum(stage_latency(task.variants[cfg.z[n]], cfg.b[n], cfg.f[n], demand,
                          speed_sum=pl.stage_speed_sum[n],
                          min_speed=pl.stage_min_speed[n])
            for n, task in enumerate(pipe.tasks))
    return L + pipe.topo.hop_latency * pl.n_hops


def resource_usage(pipe: Pipeline, cfg: Config) -> float:
    return sum(task.variants[cfg.z[n]].resource * cfg.f[n]
               for n, task in enumerate(pipe.tasks))


def resources_feasible(pipe: Pipeline, cfg: Config) -> bool:
    """The resource constraint alone: scalar pool -> Σ w·f ≤ W_max;
    heterogeneous topology -> every replica found a node (no overflow)."""
    if pipe.scalar_pool:
        return resource_usage(pipe, cfg) <= pipe.w_max
    return placement_for(pipe, cfg).feasible


def feasible(pipe: Pipeline, cfg: Config) -> bool:
    if not resources_feasible(pipe, cfg):
        return False
    for n in range(pipe.n_tasks):
        if not (0 <= cfg.z[n] < len(pipe.tasks[n].variants)):
            return False
        if not (1 <= cfg.f[n] <= pipe.f_max):
            return False
        if not (1 <= cfg.b[n] <= pipe.b_max):
            return False
    return True


def score_measurements(V: float, C: float, T: float, L: float, E: float,
                       w: QoSWeights, *, max_batch: int) -> dict:
    """Eq. (3)/(4)/(7) scoring of one interval's metrics.

    The metrics may come from the analytic model (``pipeline_metrics``) or
    from measured telemetry of the event-driven runtime — the QoS, reward and
    objective formulas are shared so env-sim and runtime-sim agree.
    """
    q = w.alpha * V + w.beta * T - L - (w.gamma * E if E >= 0
                                        else w.delta * (-E))
    r = q - w.beta_c * C - w.gamma_b * max_batch
    return {"V": V, "C": C, "T": T, "L": L, "E": E,
            "qos": q, "reward": r, "objective": q - w.lam * C}


def accuracy_and_cost(pipe: Pipeline, cfg: Config) -> tuple[float, float]:
    """Eq. (1)/(2): pipeline accuracy V and chip cost C of a configuration."""
    V = sum(task.variants[cfg.z[n]].accuracy for n, task in enumerate(pipe.tasks))
    C = sum(task.variants[cfg.z[n]].cost * cfg.f[n]
            for n, task in enumerate(pipe.tasks))
    return V, C


def evaluate(pipe: Pipeline, cfg: Config, demand: float, w: QoSWeights,
             *, cold_frac: float = 0.0) -> dict:
    """All paper metrics for one interval: Eq. (1)-(4) and (7)."""
    V, C, T, L, E, capacity = pipeline_metrics(pipe, cfg, demand,
                                               cold_frac=cold_frac)
    out = score_measurements(V, C, T, L, E, w, max_batch=max(cfg.b))
    out["capacity"] = capacity
    return out


def qos(pipe: Pipeline, cfg: Config, demand: float, w: QoSWeights) -> float:
    """Eq. (3)."""
    return evaluate(pipe, cfg, demand, w)["qos"]


def objective(pipe: Pipeline, cfg: Config, demand: float, w: QoSWeights) -> float:
    """Eq. (4):  Q − λ·C."""
    return evaluate(pipe, cfg, demand, w)["objective"]


def reward(pipe: Pipeline, cfg: Config, demand: float, w: QoSWeights) -> float:
    """Eq. (7):  Q − β_c·C − γ_b·B  (B = max batch across tasks)."""
    return evaluate(pipe, cfg, demand, w)["reward"]
