"""Per-layer rematerialisation: the counterpart of the reference's
``jax.checkpoint`` around each scanned layer body when ``cfg.remat``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig


def layer(cfg: ArchConfig, body, *args):
    """``body(*args)``; with ``cfg.remat`` and grad enabled, under
    ``torch.utils.checkpoint`` (non-reentrant): the body's activations are
    dropped after the forward and recomputed in the backward, so only the
    layer inputs stay live. The same function either way; inference paths
    (no grad) never checkpoint."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
    return body(*args)
