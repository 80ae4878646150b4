"""Whisper-style decoder (audio family). Port of ``repro/models/whisper.py``.

The mel/conv encoder frontend is a STUB, as in the reference: the caller
supplies encoder frame embeddings ``enc_states`` [B, enc_len, d]; this
module implements the decoder backbone (self-attention + cross-attention +
GELU MLP, learned positions, pre-LayerNorm). Self-attention is MHA
(n_kv = n_heads) and runs through the Hopper kernels on a CUDA tensor;
cross-attention stays the plain ``_sdpa``, as in the reference.

The cache holds the self-attention KV [L, B, C, H, hd], the cross-attention
KV [L, B, enc_len, H, hd] (``ck``/``cv``) and ``pos`` [B]. A decode step
writes its self-attention slot in place, as the dense family does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import nn as rnn
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.nn.attention import _sdpa

MAX_POSITIONS = 4096  # learned table; whisper itself uses 448 target positions


class WhisperLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.ln_self = rnn.LayerNorm(cfg.d_model, dtype=dt, device=device)
        self.self_attn = rnn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                       qkv_bias=True, **kw)
        self.ln_cross = rnn.LayerNorm(cfg.d_model, dtype=dt, device=device)
        self.cross_attn = rnn.init_cross_attention(cfg.d_model, cfg.n_heads,
                                                   cfg.head_dim, **kw)
        self.ln_mlp = rnn.LayerNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = rnn.MLP(cfg.d_model, cfg.d_ff, kind="gelu", **kw)


class Whisper(nn.Module):
    stacked_layers = True         # the reference stacks them on a leading [L, ...] axis

    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.embed = rnn.Embedding(cfg.vocab, cfg.d_model, **kw)
        self.pos = rnn.Embedding(MAX_POSITIONS, cfg.d_model, **kw)
        self.layers = nn.ModuleList(WhisperLayer(cfg, device=device, generator=generator)
                                    for _ in range(cfg.n_layers))
        self.ln_f = rnn.LayerNorm(cfg.d_model, dtype=dt, device=device)
        self.lm_head = rnn.Linear(cfg.d_model, cfg.vocab, **kw)


def init_model(seed: int, cfg: ArchConfig, *, device="cuda") -> Whisper:
    """Random weights from ``seed`` on ``device`` with the reference's
    distributions; parity tests copy the JAX weights in."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Whisper(cfg, device=dev, generator=gen)


def _cross_kv(lp: WhisperLayer, enc, cfg: ArchConfig):
    B, T, _ = enc.shape
    k = rnn.linear(lp.cross_attn.wk, enc).reshape(B, T, cfg.n_heads, cfg.head_dim)
    v = rnn.linear(lp.cross_attn.wv, enc).reshape(B, T, cfg.n_heads, cfg.head_dim)
    return k, v


def _cross_apply(lp: WhisperLayer, x, ck, cv, cfg: ArchConfig):
    B, S, _ = x.shape
    q = rnn.linear(lp.cross_attn.wq, x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    mask = torch.ones((1, 1, 1, S, ck.shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, ck, cv, mask).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return rnn.linear(lp.cross_attn.wo, out)


def _aux(h):
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return {"lb_loss": zero, "dropped_frac": zero}


def forward(params: Whisper, batch, cfg: ArchConfig, *, window=None, shard_h=None,
            last_only: bool = False, return_hidden: bool = False):
    """Teacher-forced decode over a full target sequence. batch: tokens
    [B, S], enc_states [B, enc_len, d]. ``shard_h`` and ``cfg.remat`` are
    accepted and ignored."""
    tokens = batch["tokens"]
    enc = batch["enc_states"].to(cfg.param_dtype)
    B, S = tokens.shape
    pos_ids = torch.arange(S, device=tokens.device) % MAX_POSITIONS
    h = rnn.embedding(params.embed, tokens) + rnn.embedding(params.pos, pos_ids)[None]
    for lp in params.layers:
        a, _ = rnn.attention_prefill(
            lp.self_attn, rnn.layernorm(lp.ln_self, h),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=None, window=window, use_flash=cfg.use_flash)
        h = h + a
        ck, cv = _cross_kv(lp, enc, cfg)
        h = h + _cross_apply(lp, rnn.layernorm(lp.ln_cross, h), ck, cv, cfg)
        h = h + rnn.mlp(lp.mlp, rnn.layernorm(lp.ln_mlp, h), kind="gelu")
    if last_only:
        h = h[:, -1:]
    h = rnn.layernorm(params.ln_f, h)
    if return_hidden:
        return h, _aux(h)
    return rnn.linear(params.lm_head, h), _aux(h)


def init_cache(cfg: ArchConfig, batch: int, context: int, *, dtype=None, device="cuda"):
    dt = dtype or cfg.param_dtype
    dev = resolve_device(device)
    sh = (cfg.n_layers, batch, context, cfg.n_kv, cfg.head_dim)
    shc = (cfg.n_layers, batch, cfg.enc_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(sh, dtype=dt, device=dev),
            "v": torch.zeros(sh, dtype=dt, device=dev),
            "ck": torch.zeros(shc, dtype=dt, device=dev),
            "cv": torch.zeros(shc, dtype=dt, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill_cache(params: Whisper, batch, cfg: ArchConfig, context: int):
    """Populate the cross-attention KV from encoder states (done once)."""
    enc = batch["enc_states"].to(cfg.param_dtype)
    kv = [_cross_kv(lp, enc, cfg) for lp in params.layers]
    cache = init_cache(cfg, enc.shape[0], context, device=enc.device)
    return {**cache, "ck": torch.stack([k for k, _ in kv]),
            "cv": torch.stack([v for _, v in kv])}


def decode_step(params: Whisper, batch, cache, cfg: ArchConfig, *, ring: bool = False):
    """One-token decode. Each layer writes its self-attention slot in place
    into ``cache["k"][l]`` / ``cache["v"][l]``; the returned cache holds the
    same tensors and ``pos + 1``."""
    tokens = batch["tokens"]
    pos = cache["pos"]
    pos_ids = (pos % MAX_POSITIONS)[:, None]
    h = rnn.embedding(params.embed, tokens) + rnn.embedding(params.pos, pos_ids)
    for i, lp in enumerate(params.layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        a, _ = rnn.attention_decode(
            lp.self_attn, rnn.layernorm(lp.ln_self, h), layer_cache,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=None, ring=ring, use_flash=cfg.use_flash)
        h = h + a
        h = h + _cross_apply(lp, rnn.layernorm(lp.ln_cross, h), cache["ck"][i],
                             cache["cv"][i], cfg)
        h = h + rnn.mlp(lp.mlp, rnn.layernorm(lp.ln_mlp, h), kind="gelu")
    h = rnn.layernorm(params.ln_f, h)
    logits = rnn.linear(params.lm_head, h)
    return logits, {**cache, "pos": pos + 1}
