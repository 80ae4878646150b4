"""Serving data plane of the port: batchers and the stage/pipeline engine.
The event-driven runtime, telemetry and arrivals come with the next slice."""
from repro_torch.serving.batcher import (Batcher, ContinuousBatcher, Request,
                                         stack_tokens)
from repro_torch.serving.engine import PipelineServer, StageServer
