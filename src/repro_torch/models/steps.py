"""Step-function factories (prefill / serve) and cache geometry.

``make_train_step`` and the abstract ``*_specs`` of the reference come with
the training slice (ROADMAP Queue 1 item 12)."""
from __future__ import annotations

from repro_torch.models import api, decoder, whisper
from repro_torch.models.config import LONG_WINDOW, ArchConfig, InputShape


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    return seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len


def cache_context(cfg: ArchConfig, shape: InputShape) -> int:
    """Attention-cache length: full context, or ring window for long decode."""
    if cfg.family in ("ssm",):
        return 0                                    # pure recurrent state
    if shape.seq_len > 65_536:
        return LONG_WINDOW                          # ring-buffer sliding window
    return shape.seq_len


def uses_ring(cfg: ArchConfig, shape: InputShape) -> bool:
    return shape.kind == "decode" and cfg.family != "ssm" and shape.seq_len > 65_536


def make_prefill_step(cfg: ArchConfig, *, shard_h=None):
    """(model, batch) -> (last-token logits, populated cache or aux): the
    decoder families collect their KV cache, whisper prefills its
    cross-attention cache, and the ssm and hybrid families run the forward
    only and return its aux, as the reference does."""

    def prefill_step(params, batch):
        if cfg.family == "audio":
            logits, _ = whisper.forward(params, batch, cfg, shard_h=shard_h)
            cache = whisper.prefill_cache(params, batch, cfg, batch["tokens"].shape[1])
            return logits[:, -1], cache
        if cfg.family in ("dense", "moe", "vlm"):
            logits, _, cache = decoder.forward(params, batch, cfg, shard_h=shard_h,
                                               collect_cache=True)
            return logits[:, -1], cache
        logits, aux = api.forward(params, batch, cfg, shard_h=shard_h)
        return logits[:, -1], aux

    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: InputShape):
    """(model, batch, cache) -> (logits [B, 1, V], new_cache)."""
    ring = uses_ring(cfg, shape)
    dec_cfg = cfg.replace(window=LONG_WINDOW) if ring else cfg

    def serve_step(params, batch, cache):
        return api.decode_step(params, batch, cache, dec_cfg, ring=ring)

    return serve_step
