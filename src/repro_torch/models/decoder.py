"""Decoder-only LM, dense family.

The reference stacks per-layer parameters on a leading [L, ...] axis and
``lax.scan``s them; here the layers are an ``nn.ModuleList`` walked by a
Python loop. The KV cache stays stacked, ``[L, B, C, kv, hd]`` plus
``pos [B]``, as the reference's ``init_cache`` lays it out. The MoE
interleave and the VLM prefix come with the remaining model families
(ROADMAP Queue 1 item 11 part B).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import nn as rnn
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig

_LATER = ("is not ported yet (ROADMAP Queue 1 item 11 part B, remaining model "
          "families)")


def _norm_fns(cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return rnn.LayerNorm, rnn.layernorm
    return rnn.RMSNorm, rnn.rmsnorm


def _block_k(cfg: ArchConfig) -> int:
    """Layers per scanned block in the reference: >1 when MoE is interleaved."""
    return cfg.moe_every if (cfg.n_experts and cfg.moe_every > 1) else 1


def _check_dense(cfg: ArchConfig):
    if _block_k(cfg) > 1:
        raise NotImplementedError(f"{cfg.name}: the MoE interleave {_LATER}")
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: the VLM prefix {_LATER}")
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} {_LATER}")


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        Norm, _ = _norm_fns(cfg)
        dt = cfg.param_dtype
        self.ln_attn = Norm(cfg.d_model, dtype=dt, device=device)
        self.attn = rnn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                  dtype=dt, qkv_bias=cfg.norm == "layernorm",
                                  device=device, generator=generator)
        self.ln_mlp = Norm(cfg.d_model, dtype=dt, device=device)
        self.mlp = rnn.MLP(cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind, dtype=dt,
                           device=device, generator=generator)


class DecoderLM(nn.Module):
    """Parameters of one decoder-only LM under the reference's names:
    ``embed``, ``layers`` (one ``Layer`` per depth), ``ln_f``, ``lm_head``."""

    stacked_layers = True         # the reference stacks them on a leading [L, ...] axis

    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        Norm, _ = _norm_fns(cfg)
        dt = cfg.param_dtype
        self.embed = rnn.Embedding(cfg.vocab, cfg.d_model, dtype=dt,
                                   device=device, generator=generator)
        self.layers = nn.ModuleList(
            Layer(cfg, device=device, generator=generator)
            for _ in range(cfg.n_layers))
        self.ln_f = Norm(cfg.d_model, dtype=dt, device=device)
        self.lm_head = rnn.Linear(cfg.d_model, cfg.vocab, dtype=dt,
                                  device=device, generator=generator)


def init_model(seed: int, cfg: ArchConfig, *, device="cuda") -> DecoderLM:
    """Random weights from ``seed`` on ``device``, with the reference's
    distributions (lecun-normal linears, 0.02 embedding, unit norms). The
    bits differ from ``jax.random``; parity tests copy the JAX weights in
    with ``models.convert.load_jax_params``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return DecoderLM(cfg, device=dev, generator=gen)


def embed_inputs(params: DecoderLM, batch, cfg: ArchConfig):
    """tokens [B, S] -> h [B, S, d]."""
    _check_dense(cfg)
    return rnn.embedding(params.embed, batch["tokens"])


def forward(params: DecoderLM, batch, cfg: ArchConfig, *, window=None,
            shard_h=None, collect_cache: bool = False, last_only: bool = False,
            return_hidden: bool = False):
    """Full-sequence forward -> (logits, aux[, cache]). ``last_only``
    computes logits for the final position only. ``shard_h`` (and
    ``cfg.remat``) are the reference's sharding and training concerns; they
    are accepted and ignored."""
    h = embed_inputs(params, batch, cfg)
    B, S_total = h.shape[:2]
    _, norm = _norm_fns(cfg)
    ks, vs = [], []
    for lp in params.layers:
        a, (k, v) = rnn.attention_prefill(
            lp.attn, norm(lp.ln_attn, h),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=window, use_flash=cfg.use_flash)
        h = h + a
        h = h + rnn.mlp(lp.mlp, norm(lp.ln_mlp, h), kind=cfg.mlp_kind)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    if last_only:
        h = h[:, -1:]
    h = norm(params.ln_f, h)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"lb_loss": zero, "dropped_frac": zero}
    if return_hidden:
        return h, aux
    logits = rnn.linear(params.lm_head, h)
    if collect_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": torch.full((B,), S_total, dtype=torch.int32, device=h.device)}
        return logits, aux, cache
    return logits, aux


def init_cache(cfg: ArchConfig, batch: int, context: int, *, dtype=None,
               device="cuda"):
    """Stacked per-layer KV cache [L, B, C, kv, hd] + global pos [B]."""
    dt = dtype or cfg.param_dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, context, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def decode_step(params: DecoderLM, batch, cache, cfg: ArchConfig, *,
                ring: bool = False):
    """One-token decode. batch["tokens"] [B, 1]. Returns (logits, new_cache).
    Each layer writes its new k/v slot in place into ``cache["k"][l]`` /
    ``cache["v"][l]``; the returned cache holds the same tensors and
    ``pos + 1``."""
    _check_dense(cfg)
    h = rnn.embedding(params.embed, batch["tokens"])
    pos = cache["pos"]
    _, norm = _norm_fns(cfg)
    for i, lp in enumerate(params.layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        a, _ = rnn.attention_decode(
            lp.attn, norm(lp.ln_attn, h), layer_cache,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, ring=ring, use_flash=cfg.use_flash)
        h = h + a
        h = h + rnn.mlp(lp.mlp, norm(lp.ln_mlp, h), kind=cfg.mlp_kind)
    h = norm(params.ln_f, h)
    logits = rnn.linear(params.lm_head, h)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
