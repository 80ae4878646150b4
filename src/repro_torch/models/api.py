"""Family-dispatched model API (the dense family is ported so far).

    init_model(seed, cfg, device=)            -> model (nn.Module)
    forward(model, batch, cfg, ...)           -> (logits, aux)
    init_cache(cfg, batch, context, device=)  -> cache dict
    decode_step(model, batch, cache, cfg)     -> (logits, new_cache)
"""
from __future__ import annotations

from repro_torch.models import decoder
from repro_torch.models.config import ArchConfig


# families with model code in the port; the rest arrive with ROADMAP Queue 1
# item 11 (remaining model families)
PORTED_FAMILIES = ("dense",)


def _mod(cfg: ArchConfig):
    if cfg.family in PORTED_FAMILIES:
        return decoder
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
        "Queue 1 item 11, remaining model families)")


def init_model(seed: int, cfg: ArchConfig, **kw):
    return _mod(cfg).init_model(seed, cfg, **kw)


def forward(params, batch, cfg: ArchConfig, **kw):
    return _mod(cfg).forward(params, batch, cfg, **kw)


def init_cache(cfg: ArchConfig, batch: int, context: int, **kw):
    return _mod(cfg).init_cache(cfg, batch, context, **kw)


def decode_step(params, batch, cache, cfg: ArchConfig, **kw):
    return _mod(cfg).decode_step(params, batch, cache, cfg, **kw)
