"""repro_torch.api — the declarative control-plane API of the port.

Specs (`PipelineSpec`, `ScenarioSpec`, `ControllerSpec`, `ExperimentSpec`)
describe an experiment as JSON-serializable data, identical to the
reference's; registries name the built-ins (`get_pipeline("serve2")`,
`get_scenario("bursty")`, `get_controller("capacity")`, `get_fleet(...)`,
`get_predictor(...)`); the `Session` facade owns the env / runtime /
forecaster / policy lifecycle and, for ``real`` runs, the live PyTorch
stage servers on the GPU; `FleetSession` serves N tenants on one event loop. Importing it loads neither jax
nor the JAX package.
"""
from repro_torch.api.specs import (ClusterSpec, ControllerSpec, ExperimentSpec,
                                   FleetSpec, NodeSpec, PipelineSpec, PredictorSpec,
                                   ScenarioSpec, TenantSpec, replace)
from repro_torch.api.registry import (register_pipeline, register_scenario,
                                      register_controller, register_cluster,
                                      register_fleet, register_predictor,
                                      get_pipeline, get_scenario,
                                      get_controller, get_cluster, get_fleet,
                                      get_predictor, controller_factory,
                                      list_pipelines, list_scenarios,
                                      list_controllers, list_clusters,
                                      list_fleets, list_predictors)
from repro_torch.api.session import (Session, FleetSession, build_executors,
                                     build_servers, run_experiment)
from repro_torch.core.controller import (Controller, ControllerBase,
                                         Observation, decide)
