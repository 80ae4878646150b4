"""Synthetic request prompts (NumPy, bit-identical to the reference's
``synthetic_requests``; the LM batch generator comes with training)."""
from __future__ import annotations

import numpy as np

from repro_torch.serving.batcher import Request


def synthetic_requests(n: int, *, vocab: int = 512, seq_len: int = 32,
                       seed: int = 0):
    """Request token prompts for the serving examples."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(1, vocab, size=seq_len).astype(np.int32))
            for i in range(n)]
