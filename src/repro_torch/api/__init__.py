"""repro_torch.api — the declarative control-plane API of the port.

Specs (`PipelineSpec`, `ScenarioSpec`, `ControllerSpec`, `ExperimentSpec`)
describe an experiment as JSON-serializable data, identical to the
reference's; registries name the built-ins (`get_pipeline("serve2")`,
`get_scenario("bursty")`, `get_controller("capacity")`); the `Session`
facade owns the env / runtime / policy lifecycle and, for ``real`` runs,
the live PyTorch stage servers on the GPU. Importing it loads neither jax
nor the JAX package.
"""
from repro_torch.api.specs import (ClusterSpec, ControllerSpec, ExperimentSpec,
                                   NodeSpec, PipelineSpec, PredictorSpec,
                                   ScenarioSpec, replace)
from repro_torch.api.registry import (register_pipeline, register_scenario,
                                      register_controller, register_cluster,
                                      get_pipeline, get_scenario,
                                      get_controller, get_cluster,
                                      controller_factory, list_pipelines,
                                      list_scenarios, list_controllers,
                                      list_clusters)
from repro_torch.api.session import (Session, build_executors, build_servers,
                                     run_experiment)
from repro_torch.core.controller import (Controller, ControllerBase,
                                         Observation, decide)
