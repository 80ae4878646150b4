"""Serving layer of the port: batchers, the stage/pipeline engine, arrival
processes, telemetry and the event-driven runtime. The multi-tenant fleet
comes with ROADMAP Queue 1 item 10."""
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
