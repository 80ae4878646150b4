"""Declarative experiment specs — plain frozen dataclasses, JSON-round-trip
safe, so an experiment is a reproducible artifact: ``Spec.from_dict(
spec.to_dict())`` equals the original, and running the reloaded spec
reproduces the run bit-for-bit (every random draw derives from spec seeds).

  PipelineSpec    stages × archs × quants × knob ranges  -> core Pipeline
  ScenarioSpec    arrival process + rate + seed + horizon -> ArrivalProcess
  ControllerSpec  which controller, its seed / training budget
  PredictorSpec   a load forecaster (``core/forecast.py``), as data
  ExperimentSpec  the full run: pipeline + scenario + controller + backend
  TenantSpec      one fleet tenant: pipeline + scenario + controller
                  + priority class + latency SLO
  FleetSpec       N tenants sharing one cluster on one event loop

``to_dict``/``from_dict`` are the reference's (``repro/api/specs.py``), so a
spec's JSON loads unchanged in either package.
"""
from __future__ import annotations

# ``replace`` is re-exported through repro_torch.api for spec overrides
from dataclasses import asdict, dataclass, replace  # noqa: F401

import numpy as np

from repro_torch.cluster.topology import ClusterTopology, Node
from repro_torch.cluster.workloads import WORKLOADS, make_trace
from repro_torch.core.mdp import Pipeline
from repro_torch.serving.arrivals import ArrivalProcess, TraceArrivals, make_arrivals

DEFAULT_QUANTS = ("bf16", "int8", "int4")


@dataclass(frozen=True)
class NodeSpec:
    """One edge device of a ClusterSpec, as data."""
    name: str
    capacity: float                  # chips this node contributes
    speed: float = 1.0               # service-rate factor of its device class
    device_class: str = "edge"

    def build(self) -> Node:
        return Node(name=self.name, capacity=self.capacity, speed=self.speed,
                    device_class=self.device_class)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> NodeSpec:
        return cls(name=d["name"], capacity=float(d["capacity"]),
                   speed=float(d.get("speed", 1.0)),
                   device_class=str(d.get("device_class", "edge")))


@dataclass(frozen=True)
class ClusterSpec:
    """A cluster topology — heterogeneous edge nodes plus the cross-node hop
    penalty — as JSON-round-trip data."""
    name: str
    nodes: tuple[NodeSpec, ...]
    hop_latency: float = 0.0         # s per adjacent-stage cross-node hop

    @property
    def total_capacity(self) -> float:
        return sum(n.capacity for n in self.nodes)

    def build(self) -> ClusterTopology:
        return ClusterTopology(name=self.name,
                               nodes=tuple(n.build() for n in self.nodes),
                               hop_latency=self.hop_latency)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> ClusterSpec:
        return cls(name=d["name"],
                   nodes=tuple(NodeSpec.from_dict(n) for n in d["nodes"]),
                   hop_latency=float(d.get("hop_latency", 0.0)))


@dataclass(frozen=True)
class PipelineSpec:
    """Stages × architectures × quantisation levels plus knob ranges —
    everything ``perf_model.make_pipeline`` needs, as data. ``cluster``
    (None = the homogeneous scalar pool of capacity ``w_max``) selects the
    cluster topology stage replicas are placed on; when set, the pipeline's
    W_max is the topology's total capacity.

    ``perf_source`` selects where variant latency coefficients come from:
    ``"analytic"`` (the default — pure ``perf_model`` arithmetic, bit-for-bit
    what every pre-calibration run used) or ``"calibrated"``, which rebinds
    the built pipeline onto measured ``(alpha, beta)`` from the calibration
    table named by ``calibration`` (a ``cluster.calibration.register_table``
    name or JSON path). Unlike the reference, None names no table and
    raises: the reference's default was measured on a CPU mesh, and
    ``python -m repro_torch.launch.calibrate`` measures the card's own.
    """
    name: str
    stages: tuple[tuple[str, ...], ...]      # arch names per stage
    quants: tuple[str, ...] = DEFAULT_QUANTS
    f_max: int = 8
    b_max: int = 32
    w_max: float = 64.0
    cluster: ClusterSpec | None = None
    perf_source: str = "analytic"            # "analytic" | "calibrated"
    calibration: str | None = None           # table name/path (calibrated)

    def build(self) -> Pipeline:
        from repro_torch.cluster.perf_model import make_pipeline
        from repro_torch.configs import ARCHS
        topology = self.cluster.build() if self.cluster else None
        w_max = self.cluster.total_capacity if self.cluster else self.w_max
        pipe = make_pipeline([[ARCHS[n] for n in names] for names in self.stages],
                             name=self.name, quants=self.quants,
                             f_max=self.f_max, b_max=self.b_max,
                             w_max=w_max, topology=topology)
        if self.perf_source == "analytic":
            return pipe
        if self.perf_source == "calibrated":
            from repro_torch.cluster.calibration import (calibrate_pipeline,
                                                         resolve_table)
            return calibrate_pipeline(pipe, resolve_table(self.calibration))
        raise ValueError(f"unknown perf_source {self.perf_source!r} "
                         "(one of: analytic, calibrated)")

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> PipelineSpec:
        cluster = d.get("cluster")
        return cls(name=d["name"],
                   stages=tuple(tuple(s) for s in d["stages"]),
                   quants=tuple(d.get("quants", DEFAULT_QUANTS)),
                   f_max=int(d.get("f_max", 8)), b_max=int(d.get("b_max", 32)),
                   w_max=float(d.get("w_max", 64.0)),
                   cluster=ClusterSpec.from_dict(cluster) if cluster else None,
                   perf_source=str(d.get("perf_source", "analytic")),
                   calibration=d.get("calibration"))


@dataclass(frozen=True)
class PredictorSpec:
    """A load forecaster (``core/forecast.py``), as data: backbone family,
    forecast horizons, window geometry and training budget. ``scale`` is
    the load normaliser; 0.0 (the default) means "derive from the training
    traces" (their max, rounded up), so one spec serves any rate.

    Built via ``Session`` against the scenario's own arrival family
    (``ScenarioSpec.train_trace`` episodes), so the forecaster trains on
    the workload it will serve — never on the eval stream itself."""
    name: str
    backbone: str = "lstm"           # "lstm" (paper §IV-A) | "mlstm" (xLSTM)
    horizons: tuple[int, ...] = (5, 10, 20, 60)
    history: int = 120               # seconds of load history per window
    hidden: int = 25                 # LSTM units (paper: 25)
    dim: int = 16                    # mLSTM model dim
    n_heads: int = 2                 # mLSTM heads
    epochs: int = 8
    batch: int = 256
    lr: float = 5e-3
    seed: int = 0
    scale: float = 0.0               # 0.0 = auto from training traces
    train_episodes: int = 3          # training traces drawn from the scenario

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> PredictorSpec:
        return cls(name=d["name"], backbone=str(d.get("backbone", "lstm")),
                   horizons=tuple(int(h)
                                  for h in d.get("horizons", (5, 10, 20, 60))),
                   history=int(d.get("history", 120)),
                   hidden=int(d.get("hidden", 25)),
                   dim=int(d.get("dim", 16)),
                   n_heads=int(d.get("n_heads", 2)),
                   epochs=int(d.get("epochs", 8)),
                   batch=int(d.get("batch", 256)),
                   lr=float(d.get("lr", 5e-3)),
                   seed=int(d.get("seed", 0)),
                   scale=float(d.get("scale", 0.0)),
                   train_episodes=int(d.get("train_episodes", 3)))


@dataclass(frozen=True)
class ScenarioSpec:
    """A workload: arrival kind (any of serving ``SCENARIOS`` or a paper
    workload regime from ``WORKLOADS``), its rate scale, seed and horizon.
    For workload regimes ``rate`` is the trace's peak (paper default 120).

    ``predictor`` optionally names a registered ``PredictorSpec``: the
    Session trains that forecaster on this scenario's arrival family and
    attaches it to the built env (multi-horizon forecasts on every
    Observation; horizon-matched ``predicted_load``)."""
    kind: str = "bursty"
    rate: float = 25.0
    seed: int = 0
    horizon: int = 120
    predictor: str | None = None

    def build_arrivals(self) -> ArrivalProcess:
        if self.kind in WORKLOADS:
            return TraceArrivals(make_trace(self.kind, seed=self.seed,
                                            peak=self.rate), seed=self.seed)
        return make_arrivals(self.kind, rate=self.rate, seed=self.seed)

    def eval_trace(self) -> np.ndarray:
        """Per-second rate profile over the horizon — the analytic
        backend's workload trace."""
        if self.kind in WORKLOADS:
            return make_trace(self.kind, seed=self.seed, peak=self.rate,
                              seconds=self.horizon)
        return self.build_arrivals().rates(self.horizon)

    def train_arrivals(self, episode: int) -> ArrivalProcess:
        """Arrival process for runtime-twin PPO episode ``episode`` — the
        scenario's own arrival family at the scenario rate, with a seed
        decorrelated from the eval stream and across episodes."""
        seed = self.seed + 7919 * (episode + 1)
        if self.kind in WORKLOADS:
            return TraceArrivals(make_trace(self.kind, seed=seed,
                                            peak=self.rate), seed=seed)
        return make_arrivals(self.kind, rate=self.rate, seed=seed)

    def train_trace(self, episode: int, *, seconds: int = 1200) -> np.ndarray:
        """Training trace for PPO episode ``episode`` — covers the demand
        levels the scenario will serve, decorrelated across episodes."""
        if self.kind in WORKLOADS:
            return make_trace(self.kind, seed=episode, peak=self.rate,
                              seconds=seconds)
        base = self.build_arrivals().rates(seconds)
        return np.roll(base, 37 * episode)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> ScenarioSpec:
        return cls(kind=d["kind"], rate=float(d.get("rate", 25.0)),
                   seed=int(d.get("seed", 0)),
                   horizon=int(d.get("horizon", 120)),
                   predictor=d.get("predictor"))


@dataclass(frozen=True)
class ControllerSpec:
    """Which controller runs the loop, and every knob that affects its
    decisions: RNG seed, OPD decode mode and PPO training budget."""
    name: str = "greedy"
    seed: int = 0
    greedy: bool = True          # OPD decode mode (argmax vs sample)
    train_episodes: int = 0      # PPO episodes before serving (OPD only)
    train_seconds: int = 1200    # length of each training trace
    expert_freq: int = 2         # Alg. 2 expert-guided episode frequency
    num_envs: int = 1            # parallel envs per PPO episode (>1 with
    #                              the analytic backend -> core.vecenv)
    train_backend: str = "analytic"  # what on-policy episodes roll on:
    #                              "analytic" (closed-form PipelineEnv) or
    #                              "runtime" (core.runtime_vec, the jitted
    #                              discrete-event twin of ServingRuntime)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> ControllerSpec:
        return cls(name=d["name"], seed=int(d.get("seed", 0)),
                   greedy=bool(d.get("greedy", True)),
                   train_episodes=int(d.get("train_episodes", 0)),
                   train_seconds=int(d.get("train_seconds", 1200)),
                   expert_freq=int(d.get("expert_freq", 2)),
                   num_envs=int(d.get("num_envs", 1)),
                   train_backend=str(d.get("train_backend", "analytic")))


@dataclass(frozen=True)
class ExperimentSpec:
    """One full run. ``backend`` selects the simulator: "runtime" steps the
    event-driven ServingRuntime (measured telemetry), "analytic" steps the
    closed-form PipelineEnv (cheap, used for training). ``real`` attaches
    live PyTorch models as stage executors (runtime backend only): full
    width on the session's device."""
    pipeline: PipelineSpec
    scenario: ScenarioSpec
    controller: ControllerSpec
    backend: str = "runtime"     # "runtime" | "analytic"
    real: bool = False
    seq_len: int = 32

    def to_dict(self) -> dict:
        return {"pipeline": self.pipeline.to_dict(),
                "scenario": self.scenario.to_dict(),
                "controller": self.controller.to_dict(),
                "backend": self.backend, "real": self.real,
                "seq_len": self.seq_len}

    @classmethod
    def from_dict(cls, d: dict) -> ExperimentSpec:
        return cls(pipeline=PipelineSpec.from_dict(d["pipeline"]),
                   scenario=ScenarioSpec.from_dict(d["scenario"]),
                   controller=ControllerSpec.from_dict(d["controller"]),
                   backend=d.get("backend", "runtime"),
                   real=bool(d.get("real", False)),
                   seq_len=int(d.get("seq_len", 32)))


@dataclass(frozen=True)
class TenantSpec:
    """One fleet tenant: its pipeline (rebound onto the fleet's shared
    cluster at build time), workload, per-pipeline controller, priority
    class (higher admits longer under overload and weighs heavier in the
    fleet's capacity arbitration) and an optional p99 latency SLO (seconds)
    reported against measured telemetry."""
    name: str
    pipeline: PipelineSpec
    scenario: ScenarioSpec
    controller: ControllerSpec
    priority: int = 1
    slo_p99: float | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "pipeline": self.pipeline.to_dict(),
                "scenario": self.scenario.to_dict(),
                "controller": self.controller.to_dict(),
                "priority": self.priority, "slo_p99": self.slo_p99}

    @classmethod
    def from_dict(cls, d: dict) -> TenantSpec:
        slo = d.get("slo_p99")
        return cls(name=d["name"],
                   pipeline=PipelineSpec.from_dict(d["pipeline"]),
                   scenario=ScenarioSpec.from_dict(d["scenario"]),
                   controller=ControllerSpec.from_dict(d["controller"]),
                   priority=int(d.get("priority", 1)),
                   slo_p99=None if slo is None else float(slo))


@dataclass(frozen=True)
class FleetSpec:
    """N tenants multiplexed onto one shared cluster and one virtual-time
    event loop. ``admission_limit`` is the fleet-wide backlog ceiling the
    priority-graded load shedder works against (None = never shed);
    ``min_share`` floors every tenant's slice of the cluster so arbitration
    cannot starve a quiet tenant."""
    name: str
    cluster: ClusterSpec
    tenants: tuple[TenantSpec, ...]
    admission_limit: float | None = None
    min_share: float = 0.08
    seq_len: int = 32

    @property
    def horizon(self) -> int:
        """Fleet serving horizon: the longest tenant scenario."""
        return max(t.scenario.horizon for t in self.tenants)

    def tenant_pipeline(self, tenant: TenantSpec) -> PipelineSpec:
        """The tenant's pipeline rebound onto the fleet's shared cluster."""
        return replace(tenant.pipeline, cluster=self.cluster)

    def to_dict(self) -> dict:
        return {"name": self.name, "cluster": self.cluster.to_dict(),
                "tenants": [t.to_dict() for t in self.tenants],
                "admission_limit": self.admission_limit,
                "min_share": self.min_share, "seq_len": self.seq_len}

    @classmethod
    def from_dict(cls, d: dict) -> FleetSpec:
        limit = d.get("admission_limit")
        return cls(name=d["name"],
                   cluster=ClusterSpec.from_dict(d["cluster"]),
                   tenants=tuple(TenantSpec.from_dict(t)
                                 for t in d["tenants"]),
                   admission_limit=None if limit is None else float(limit),
                   min_share=float(d.get("min_share", 0.08)),
                   seq_len=int(d.get("seq_len", 32)))
