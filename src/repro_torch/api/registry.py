"""Named registries for pipelines, scenarios and controllers.

Registering makes a spec discoverable by name (``get_* `` / ``list_*``), so
entry points build everything as data instead of copy-pasted wiring:

    exp = ExperimentSpec(pipeline=get_pipeline("serve2"),
                         scenario=get_scenario("bursty"),
                         controller=get_controller("opd"))

Controllers additionally register a *factory* ``(spec, pipe, params) ->
controller instance`` used by the Session when serving starts; ``params`` is
the trained policy state for learned controllers (None otherwise).

The port registers the same names as ``repro/api/registry.py``. The learned
and forecast-driven controllers (``opd``, ``proactive``,
``proactive-expert``, ``proactive-capacity``) are registered with their
reference specs and factories that raise until ROADMAP Queue 1 items 3 and
9 port them. Fleets (item 10) and predictors (item 9) are not registered yet.
"""
from __future__ import annotations

from repro_torch.api.specs import (ClusterSpec, ControllerSpec, NodeSpec,
                                   PipelineSpec, ScenarioSpec)
from repro_torch.cluster.workloads import WORKLOADS
from repro_torch.serving.arrivals import SCENARIOS

_PIPELINES: dict[str, PipelineSpec] = {}
_SCENARIOS: dict[str, ScenarioSpec] = {}
_CONTROLLERS: dict[str, tuple[ControllerSpec, object]] = {}
_CLUSTERS: dict[str, ClusterSpec] = {}


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


def _not_ported(name: str, item: str):
    """Factory of a controller the port does not have yet: raises when the
    Session builds it, so the name and spec stay registered as in the
    reference but nothing else runs in its place."""
    def factory(spec, pipe, params):
        raise NotImplementedError(
            f"controller {name!r} is not ported yet (ROADMAP Queue 1 {item})")
    return factory


def _register_builtin_controllers():
    from repro_torch.core.baselines import GreedyPolicy, IPAPolicy, RandomPolicy
    from repro_torch.core.expert import CapacityPolicy, ExpertPolicy

    register_controller(
        "opd", _not_ported("opd", "item 3, the OPD agent"),
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
    # forecast-driven pre-warm wrappers (a trained OPD policy, the expert,
    # the capacity policy inside a ProactiveController)
    register_controller(
        "proactive",
        _not_ported("proactive", "items 3 and 9, the OPD agent and forecasting"),
        spec=ControllerSpec(name="proactive", train_episodes=4, num_envs=4))
    register_controller(
        "proactive-expert",
        _not_ported("proactive-expert", "item 9, forecasting + proactive control"))
    register_controller(
        "proactive-capacity",
        _not_ported("proactive-capacity", "item 9, forecasting + proactive control"))


_register_builtin_clusters()
_register_builtin_pipelines()
_register_builtin_scenarios()
_register_builtin_controllers()
