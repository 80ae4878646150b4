"""The paper's problem model (§III) — so far only the ``Config`` decision
that ``serving.engine.PipelineServer.apply_config`` takes. The pipeline,
metrics, QoS and objective of the reference module come with the runtime
slice (ROADMAP Queue 1)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Config:
    """One decision a_t: per-task (variant z, replicas f, batch b)."""
    z: tuple[int, ...]
    f: tuple[int, ...]
    b: tuple[int, ...]

    def as_array(self) -> np.ndarray:
        return np.array([self.z, self.f, self.b], dtype=np.int64).T   # [N, 3]
