"""Request batching: each pipeline stage has a centralized queue (paper
§III-A). NumPy, bit-identical to ``repro/serving/batcher.py``.

Two batchers:

- ``Batcher`` — the simple drain-the-queue batcher used by the blocking
  ``PipelineServer`` path. It dispatches the *actual* number of pending
  requests (up to ``batch_size``); no tail padding.
- ``ContinuousBatcher`` — the event-driven runtime's batcher: requests are
  timestamped on enqueue and a batch dispatches when it is *full* or when the
  oldest request has waited ``max_wait`` virtual seconds.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # [S] int32 prompt for the first stage
    arrival: float = 0.0               # virtual arrival time (s)
    finish: float | None = None        # virtual completion time (s)
    result: np.ndarray | None = None
    stage_outputs: list = field(default_factory=list)

    @property
    def latency(self) -> float | None:
        """End-to-end virtual latency, once served."""
        return None if self.finish is None else self.finish - self.arrival


def stack_tokens(reqs: list[Request], seq_len: int) -> np.ndarray:
    """Stack request prompts -> tokens [len(reqs), seq_len], zero-padding
    (or truncating) each sequence to ``seq_len``."""
    toks = np.zeros((len(reqs), seq_len), dtype=np.int32)
    for i, req in enumerate(reqs):
        src = req.tokens[:seq_len]
        toks[i, :len(src)] = src
    return toks


class Batcher:
    def __init__(self, batch_size: int, seq_len: int):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.queue: deque[Request] = deque()

    def put(self, req: Request):
        self.queue.append(req)

    def __len__(self) -> int:
        return len(self.queue)

    def next_batch(self) -> tuple[list[Request], np.ndarray] | None:
        """Pop up to batch_size requests -> (requests, tokens [B_actual, S])."""
        if not self.queue:
            return None
        reqs = [self.queue.popleft()
                for _ in range(min(self.batch_size, len(self.queue)))]
        return reqs, stack_tokens(reqs, self.seq_len)


class ContinuousBatcher:
    """Timeout-or-full batching against a virtual clock.

    ``ready(now)`` is True when a batch should dispatch; ``deadline()`` is
    the virtual time at which the oldest pending request times out.
    """

    def __init__(self, batch_size: int, *, max_wait: float = 0.05):
        self.batch_size = int(batch_size)
        self.max_wait = float(max_wait)
        self.queue: deque[tuple[Request, float]] = deque()

    def put(self, req: Request, now: float):
        self.queue.append((req, now))

    def __len__(self) -> int:
        return len(self.queue)

    def deadline(self) -> float | None:
        """Virtual time when the oldest request's wait hits ``max_wait``."""
        if not self.queue:
            return None
        return self.queue[0][1] + self.max_wait

    def ready(self, now: float) -> bool:
        if not self.queue:
            return False
        return (len(self.queue) >= self.batch_size
                or now >= self.deadline() - 1e-12)

    def pop(self, now: float) -> list[Request]:
        """Dispatch up to ``batch_size`` requests (actual count, no padding)."""
        n = min(self.batch_size, len(self.queue))
        return [self.queue.popleft()[0] for _ in range(n)]
