"""Family-dispatched model API: every family of ``ARCHS`` (dense, moe and
vlm on ``decoder``, audio on ``whisper``, ssm on ``xlstm_lm``, hybrid on
``zamba``).

    init_model(seed, cfg, device=)            -> model (nn.Module)
    forward(model, batch, cfg, ...)           -> (logits, aux)
    init_cache(cfg, batch, context, device=)  -> cache dict
    decode_step(model, batch, cache, cfg)     -> (logits, new_cache)
"""
from __future__ import annotations

from repro_torch import tracing
from repro_torch.models import decoder, whisper, xlstm_lm, zamba
from repro_torch.models.config import ArchConfig


def _mod(cfg: ArchConfig):
    if cfg.family == "audio":
        return whisper
    if cfg.family == "hybrid":
        return zamba
    if cfg.family == "ssm":
        return xlstm_lm
    return decoder          # dense | moe | vlm


def init_model(seed: int, cfg: ArchConfig, **kw):
    return _mod(cfg).init_model(seed, cfg, **kw)


def forward(params, batch, cfg: ArchConfig, **kw):
    """The family's forward, between the two outer bounds of its
    ``tracing`` kinds (the dense, moe, vlm and audio families mark the
    kinds inside; the hybrid and ssm families are timed whole)."""
    tracing.mark(None, batch["tokens"])
    out = _mod(cfg).forward(params, batch, cfg, **kw)
    tracing.mark(None, batch["tokens"])
    return out


def init_cache(cfg: ArchConfig, batch: int, context: int, **kw):
    return _mod(cfg).init_cache(cfg, batch, context, **kw)


def decode_step(params, batch, cache, cfg: ArchConfig, **kw):
    return _mod(cfg).decode_step(params, batch, cache, cfg, **kw)
