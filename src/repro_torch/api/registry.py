"""Named registries for pipelines, scenarios and controllers.

Registering makes a spec discoverable by name (``get_* `` / ``list_*``), so
entry points build everything as data instead of copy-pasted wiring:

    exp = ExperimentSpec(pipeline=get_pipeline("serve2"),
                         scenario=get_scenario("bursty"),
                         controller=get_controller("opd"))

Controllers additionally register a *factory* ``(spec, pipe, params) ->
controller instance`` used by the Session when serving starts; ``params`` is
the trained policy state for learned controllers (None otherwise).

The port registers the same names and specs as ``repro/api/registry.py``;
a learned policy (``opd``, and the one inside ``proactive``) decides on the
device its parameters live on.
"""
from __future__ import annotations

from repro_torch.api.specs import (ClusterSpec, ControllerSpec, FleetSpec,
                                   NodeSpec, PipelineSpec, PredictorSpec,
                                   ScenarioSpec, TenantSpec)
from repro_torch.cluster.workloads import WORKLOADS
from repro_torch.serving.arrivals import SCENARIOS

_PIPELINES: dict[str, PipelineSpec] = {}
_SCENARIOS: dict[str, ScenarioSpec] = {}
_CONTROLLERS: dict[str, tuple[ControllerSpec, object]] = {}
_CLUSTERS: dict[str, ClusterSpec] = {}
_FLEETS: dict[str, FleetSpec] = {}
_PREDICTORS: dict[str, PredictorSpec] = {}


# ---------------------------------------------------------------- pipelines --

def register_pipeline(spec: PipelineSpec, *, name: str | None = None) -> PipelineSpec:
    _PIPELINES[name or spec.name] = spec
    return spec


def get_pipeline(name: str) -> PipelineSpec:
    try:
        return _PIPELINES[name]
    except KeyError:
        raise KeyError(f"unknown pipeline {name!r}; "
                       f"registered: {list_pipelines()}") from None


def list_pipelines() -> tuple[str, ...]:
    return tuple(sorted(_PIPELINES))


# ---------------------------------------------------------------- scenarios --

def register_scenario(name: str, spec: ScenarioSpec) -> ScenarioSpec:
    _SCENARIOS[name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {list_scenarios()}") from None


def list_scenarios() -> tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


# ----------------------------------------------------------------- clusters --

def register_cluster(spec: ClusterSpec, *, name: str | None = None) -> ClusterSpec:
    _CLUSTERS[name or spec.name] = spec
    return spec


def get_cluster(name: str) -> ClusterSpec:
    try:
        return _CLUSTERS[name]
    except KeyError:
        raise KeyError(f"unknown cluster {name!r}; "
                       f"registered: {list_clusters()}") from None


def list_clusters() -> tuple[str, ...]:
    return tuple(sorted(_CLUSTERS))


# ------------------------------------------------------------------- fleets --

def register_fleet(spec: FleetSpec, *, name: str | None = None) -> FleetSpec:
    _FLEETS[name or spec.name] = spec
    return spec


def get_fleet(name: str) -> FleetSpec:
    try:
        return _FLEETS[name]
    except KeyError:
        raise KeyError(f"unknown fleet {name!r}; "
                       f"registered: {list_fleets()}") from None


def list_fleets() -> tuple[str, ...]:
    return tuple(sorted(_FLEETS))


# --------------------------------------------------------------- predictors --

def register_predictor(spec: PredictorSpec, *,
                       name: str | None = None) -> PredictorSpec:
    _PREDICTORS[name or spec.name] = spec
    return spec


def get_predictor(name: str) -> PredictorSpec:
    try:
        return _PREDICTORS[name]
    except KeyError:
        raise KeyError(f"unknown predictor {name!r}; "
                       f"registered: {list_predictors()}") from None


def list_predictors() -> tuple[str, ...]:
    return tuple(sorted(_PREDICTORS))


# -------------------------------------------------------------- controllers --

def register_controller(name: str, factory, *,
                        spec: ControllerSpec | None = None) -> None:
    """``factory(spec, pipe, params) -> controller``; ``spec`` is the default
    ControllerSpec handed out by ``get_controller(name)``."""
    _CONTROLLERS[name] = (spec or ControllerSpec(name=name), factory)


def get_controller(name: str) -> ControllerSpec:
    try:
        return _CONTROLLERS[name][0]
    except KeyError:
        raise KeyError(f"unknown controller {name!r}; "
                       f"registered: {list_controllers()}") from None


def controller_factory(name: str):
    return _CONTROLLERS[name][1]


def list_controllers() -> tuple[str, ...]:
    return tuple(sorted(_CONTROLLERS))


# ---------------------------------------------------------------- built-ins --

def _register_builtin_clusters():
    # the paper's cluster: one homogeneous scalar pool of W_max = 64 chips —
    # the default every existing pipeline implicitly runs on
    register_cluster(ClusterSpec(
        name="homogeneous",
        nodes=(NodeSpec("edge-0", capacity=64.0),)))
    # a big/medium/small edge cell (EdgeSight-style heterogeneous fleet):
    # same 64-chip total as the paper's pool, but fragmented across device
    # classes with different service speeds and a 20 ms cross-node hop
    register_cluster(ClusterSpec(
        name="edge-hetero-3",
        nodes=(NodeSpec("big", capacity=32.0, speed=1.25,
                        device_class="server"),
               NodeSpec("medium", capacity=20.0, speed=1.0,
                        device_class="edge-box"),
               NodeSpec("small", capacity=12.0, speed=0.7,
                        device_class="device")),
        hop_latency=0.02))
    # a tightly constrained two-device cell: little total capacity, slow
    # devices, expensive hops — placement pressure dominates every decision
    register_cluster(ClusterSpec(
        name="edge-constrained",
        nodes=(NodeSpec("cell-a", capacity=12.0, speed=0.8,
                        device_class="device"),
               NodeSpec("cell-b", capacity=8.0, speed=0.6,
                        device_class="device")),
        hop_latency=0.05))


def _register_builtin_pipelines():
    # the paper's 4-stage pipeline (perf_model.default_pipeline as data)
    register_pipeline(PipelineSpec(
        name="paper-4stage",
        stages=(("whisper-small", "xlstm-125m"),
                ("llama3.2-1b", "starcoder2-3b"),
                ("granite-moe-3b-a800m", "zamba2-2.7b"),
                ("granite-3-8b", "llava-next-mistral-7b"))))
    # the launcher's 2-stage serving pipeline
    register_pipeline(PipelineSpec(
        name="serve2",
        stages=(("whisper-small", "xlstm-125m"),
                ("llama3.2-1b", "starcoder2-3b")),
        quants=("bf16",)))
    # the closed-loop demo / runtime-benchmark 3-stage pipeline
    register_pipeline(PipelineSpec(
        name="serve3",
        stages=(("xlstm-125m", "whisper-small"),
                ("llama3.2-1b", "starcoder2-3b"),
                ("granite-moe-3b-a800m", "zamba2-2.7b")),
        quants=("bf16",)))
    # the same 3-stage pipeline on the heterogeneous big/medium/small edge
    # cell — placement-aware physics (node speeds, per-node feasibility,
    # cross-node hops) and the per-node Eq. (5) state extension
    register_pipeline(PipelineSpec(
        name="serve3-hetero",
        stages=(("xlstm-125m", "whisper-small"),
                ("llama3.2-1b", "starcoder2-3b"),
                ("granite-moe-3b-a800m", "zamba2-2.7b")),
        quants=("bf16",),
        cluster=_CLUSTERS["edge-hetero-3"]))


def _register_builtin_scenarios():
    for kind in SCENARIOS:          # event-driven arrival processes
        register_scenario(kind, ScenarioSpec(kind=kind, rate=25.0, seed=0,
                                             horizon=120))
    for kind in WORKLOADS:          # the paper's Fig. 4 workload regimes
        register_scenario(kind, ScenarioSpec(kind=kind, rate=120.0, seed=0,
                                             horizon=1200))


def _register_builtin_fleets():
    # three tenant classes sharing the heterogeneous big/medium/small edge
    # cell: a latency-critical interactive tenant (highest priority, tight
    # p99 SLO), a steady analytics tenant, and a best-effort batch tenant
    # (lowest priority — first to shed under fleet overload)
    register_fleet(FleetSpec(
        name="fleet-3tenant-hetero",
        cluster=_CLUSTERS["edge-hetero-3"],
        admission_limit=400.0,
        tenants=(
            TenantSpec(name="interactive",
                       pipeline=_PIPELINES["serve2"],
                       scenario=ScenarioSpec(kind="bursty", rate=25.0,
                                             seed=0, horizon=120),
                       controller=ControllerSpec(name="greedy"),
                       priority=3, slo_p99=2.0),
            TenantSpec(name="analytics",
                       pipeline=_PIPELINES["serve3"],
                       scenario=ScenarioSpec(kind="poisson", rate=15.0,
                                             seed=1, horizon=120),
                       controller=ControllerSpec(name="ipa"),
                       priority=2, slo_p99=5.0),
            TenantSpec(name="batch",
                       pipeline=_PIPELINES["serve2"],
                       scenario=ScenarioSpec(kind="ramp", rate=20.0,
                                             seed=2, horizon=120),
                       controller=ControllerSpec(name="greedy"),
                       priority=1),
        )))


def _register_builtin_predictors():
    # the paper's §IV-A predictor as a forecaster: 25-unit LSTM, single
    # 20 s horizon — a drop-in for core/predictor.py through the spec path
    register_predictor(PredictorSpec(name="lstm-20s", backbone="lstm",
                                     horizons=(20,)))
    # paper-faithful LSTM emitting every proactive-control horizon from one
    # backbone pass — what the pre-warm baseline consumes by default
    register_predictor(PredictorSpec(name="lstm-multi", backbone="lstm",
                                     horizons=(5, 10, 20, 60)))
    # the xLSTM matrix-memory backbone (nn/xlstm.py) at the same horizons —
    # parallelisable over the window; needs a longer schedule to converge
    register_predictor(PredictorSpec(name="mlstm-multi", backbone="mlstm",
                                     horizons=(5, 10, 20, 60),
                                     epochs=20, lr=3e-3))


def _register_builtin_controllers():
    from repro_torch.core.baselines import GreedyPolicy, IPAPolicy, RandomPolicy
    from repro_torch.core.expert import CapacityPolicy, ExpertPolicy
    from repro_torch.core.opd import OPDPolicy
    from repro_torch.core.proactive import ProactiveController

    register_controller(
        "opd", lambda spec, pipe, params: OPDPolicy(
            pipe, params, greedy=spec.greedy, seed=spec.seed,
            device=next(params.parameters()).device),
        spec=ControllerSpec(name="opd", train_episodes=4, num_envs=4))
    register_controller("greedy", lambda spec, pipe, params: GreedyPolicy(pipe))
    register_controller(
        "ipa", lambda spec, pipe, params: IPAPolicy(pipe))
    register_controller(
        "random", lambda spec, pipe, params: RandomPolicy(pipe, seed=spec.seed))
    register_controller(
        "expert", lambda spec, pipe, params: ExpertPolicy(pipe))
    # demand-matched min-cost: cheapest demand-covering config over the FULL
    # variant space — variants switch with load (greedy's stay pinned)
    register_controller(
        "capacity", lambda spec, pipe, params: CapacityPolicy(pipe))
    # forecast-driven pre-warm wrapper around a trained OPD policy: same
    # training path as "opd", plus a prewarm_plan consumed by RuntimeEnv
    register_controller(
        "proactive", lambda spec, pipe, params: ProactiveController(
            OPDPolicy(pipe, params, greedy=spec.greedy, seed=spec.seed,
                      device=next(params.parameters()).device)),
        spec=ControllerSpec(name="proactive", train_episodes=4, num_envs=4))
    # the same wrapper around the demand-matched analytic expert — the
    # expert re-sizes (variant, replicas, batch) with predicted load, so the
    # forecast moves real capacity ahead of a burst and the pre-warm slot
    # absorbs the variant-switch cold start (fig45 proactive comparison)
    register_controller(
        "proactive-expert",
        lambda spec, pipe, params: ProactiveController(ExpertPolicy(pipe)))
    # the headline fig45 proactive arm: min-cost inner, so the forecast's
    # early variant switches are pre-warmed at a config cost below the
    # reactive baselines (accuracy-first experts overspend on ramps)
    register_controller(
        "proactive-capacity",
        lambda spec, pipe, params: ProactiveController(CapacityPolicy(pipe)))


_register_builtin_clusters()
_register_builtin_pipelines()
_register_builtin_scenarios()
_register_builtin_fleets()
_register_builtin_predictors()
_register_builtin_controllers()
