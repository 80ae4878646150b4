"""Serving layer of the port: batchers, the stage/pipeline engine, arrival
processes, telemetry, the event-driven runtime and the multi-tenant fleet
on one shared event loop."""
from repro_torch.serving.batcher import (Batcher, ContinuousBatcher, Request,
                                         stack_tokens)
from repro_torch.serving.engine import PipelineServer, StageServer
from repro_torch.serving.arrivals import (ArrivalProcess, PoissonArrivals,
                                          TraceArrivals, BurstyArrivals,
                                          RampArrivals, make_arrivals,
                                          arrivals_from_dict, SCENARIOS)
from repro_torch.serving.telemetry import Telemetry, percentile
from repro_torch.serving.runtime import (ServingRuntime, RuntimeStage, EventLoop,
                                         COLD_START_SECONDS)
from repro_torch.serving.fleet import (FleetRuntime, FleetTenant, build_fleet,
                                       scale_topology)
