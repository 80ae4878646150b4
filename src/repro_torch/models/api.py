"""Family-dispatched model API (the dense, audio and ssm families are
ported so far).

    init_model(seed, cfg, device=)            -> model (nn.Module)
    forward(model, batch, cfg, ...)           -> (logits, aux)
    init_cache(cfg, batch, context, device=)  -> cache dict
    decode_step(model, batch, cache, cfg)     -> (logits, new_cache)
"""
from __future__ import annotations

from repro_torch.models import decoder, whisper, xlstm_lm
from repro_torch.models.config import ArchConfig


# families with model code in the port; the rest (moe, vlm, hybrid) arrive
# with ROADMAP Queue 1 item 11 part B (remaining model families)
_MODULES = {"dense": decoder, "audio": whisper, "ssm": xlstm_lm}
PORTED_FAMILIES = tuple(_MODULES)


def _mod(cfg: ArchConfig):
    if cfg.family in PORTED_FAMILIES:
        return _MODULES[cfg.family]
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
        "Queue 1 item 11 part B, remaining model families)")


def init_model(seed: int, cfg: ArchConfig, **kw):
    return _mod(cfg).init_model(seed, cfg, **kw)


def forward(params, batch, cfg: ArchConfig, **kw):
    return _mod(cfg).forward(params, batch, cfg, **kw)


def init_cache(cfg: ArchConfig, batch: int, context: int, **kw):
    return _mod(cfg).init_cache(cfg, batch, context, **kw)


def decode_step(params, batch, cache, cfg: ArchConfig, **kw):
    return _mod(cfg).decode_step(params, batch, cache, cfg, **kw)
