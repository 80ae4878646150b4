"""Zamba2-style hybrid (hybrid family): a Mamba2 backbone with ONE shared
attention + SwiGLU block applied before each group of ``attn_every`` mamba
layers. Port of ``repro/models/zamba.py``.

The reference stacks the mamba layers on two leading axes, leaves
``[G, attn_every, ...]``; here ``mamba_layers`` is a ``ModuleList`` of G
``ModuleList``s of ``attn_every`` layers. The cache holds a KV cache per
shared-block application only (``k``/``v`` [G, B, C, kv, hd]), the SSM
state (``ssm`` float32 [G, attn_every, B, H, P, N]), the conv tails
(``conv`` [G, attn_every, B, CONV_K-1, d_inner + 2N]) and ``pos`` [B].
A decode step writes its k/v slots in place, as the dense family does, and
returns new ``ssm``/``conv`` tensors, leaving the ones it was given
untouched (a replayed CUDA graph then recomputes the same step).

Under a running mesh (``distributed.collectives``) each rank holds its
blocks (``distributed.sharding.place``): the shared attention + SwiGLU
block takes the decoder's tensor-parallel path and decodes over a KV cache
split over C; each Mamba2 layer computes the rank's channels and heads of
``d_inner`` (``nn.mamba2``), its SSM state the rank's heads and its conv
tail whole; the embedding and ``lm_head`` split by vocab (or width). With
``shard_h`` each group's output keeps the rank's block of the sequence,
which the next group gathers (the reference constrains each group's input
and output).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import nn as rnn
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.models import remat
from repro_torch.models.config import ArchConfig
from repro_torch.models.decoder import lm_head
from repro_torch.nn.mamba2 import CONV_K


def n_groups(cfg: ArchConfig) -> int:
    if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a multiple of "
                         f"attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


class MambaLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        self.ln = rnn.RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mamba = rnn.Mamba2(cfg.d_model, n_heads=cfg.n_heads, d_state=cfg.ssm_state,
                                dtype=dt, device=device, generator=generator)


class SharedBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.ln_attn = rnn.RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = rnn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, **kw)
        self.ln_mlp = rnn.RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = rnn.MLP(cfg.d_model, cfg.d_ff, kind="swiglu", **kw)


class Zamba(nn.Module):
    """``embed``, ``shared``, ``mamba_layers`` (G × attn_every), ``ln_f``,
    ``lm_head``, under the reference's names."""

    # the reference stacks ``mamba_layers`` on two leading axes ([G, attn_every, ...])
    stacked_layers = {"mamba_layers": 2}

    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.embed = rnn.Embedding(cfg.vocab, cfg.d_model, **kw)
        self.shared = SharedBlock(cfg, device=device, generator=generator)
        self.mamba_layers = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, device=device, generator=generator)
                          for _ in range(cfg.attn_every))
            for _ in range(n_groups(cfg)))
        self.ln_f = rnn.RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.lm_head = rnn.Linear(cfg.d_model, cfg.vocab, **kw)


def init_model(seed: int, cfg: ArchConfig, *, device="cuda") -> Zamba:
    """Random weights from ``seed`` on ``device`` with the reference's
    distributions; parity tests copy the JAX weights in."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Zamba(cfg, device=dev, generator=gen)


def _shared_block(sp: SharedBlock, h, cfg: ArchConfig, *, window=None, sdpa=False):
    a, _ = rnn.attention_prefill(
        sp.attn, rnn.rmsnorm(sp.ln_attn, h),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=window, use_flash=cfg.use_flash, sdpa=sdpa)
    h = h + a
    return h + rnn.mlp(sp.mlp, rnn.rmsnorm(sp.ln_mlp, h), kind="swiglu")


def forward(params: Zamba, batch, cfg: ArchConfig, *, window=None, shard_h=None,
            last_only: bool = False, return_hidden: bool = False, sdpa: bool = False,
            vocab_block: bool = False):
    """tokens [B, S] -> (logits, aux); aux is zero (no MoE). ``sdpa`` goes
    to the shared block's ``attention_prefill``; ``shard_h``
    (``distributed.sharding.residual_constraint``) is applied to each
    group's output (module docstring); ``vocab_block`` returns a
    vocab-split ``lm_head``'s block of the logits ungathered. With
    ``cfg.remat`` and grad enabled each group (the shared block and its
    mamba layers) is recomputed in the backward (``models.remat``), as the
    reference checkpoints its group body."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    h = rnn.embedding(params.embed, tokens, cfg.vocab, cfg.d_model)

    def body(group, h):
        if h.shape[1] != S:                               # a sequence block: gather it
            h = col.gather(h, "model", 1)
        h = _shared_block(params.shared, h, cfg, window=window, sdpa=sdpa)
        for lp in group:
            h = h + rnn.mamba2_scan(lp.mamba, rnn.rmsnorm(lp.ln, h),
                                    n_heads=cfg.n_heads, d_state=cfg.ssm_state)
        return h if shard_h is None else shard_h(h)

    for group in params.mamba_layers:
        h = remat.layer(cfg, body, group, h)
    if h.shape[1] != S:
        h = col.gather(h, "model", 1)
    if last_only:
        h = h[:, -1:]
    h = rnn.rmsnorm(params.ln_f, h)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"lb_loss": zero, "dropped_frac": zero}
    if return_hidden:
        return h, aux
    return lm_head(params, h, cfg, vocab_block=vocab_block), aux


def init_cache(cfg: ArchConfig, batch: int, context: int, *, dtype=None,
               device="cuda"):
    dt = dtype or cfg.param_dtype
    dev = resolve_device(device)
    G = n_groups(cfg)
    sh = (G, batch, context, cfg.n_kv, cfg.head_dim)
    d_inner = 2 * cfg.d_model
    P = d_inner // cfg.n_heads
    return {
        "k": torch.zeros(sh, dtype=dt, device=dev),
        "v": torch.zeros(sh, dtype=dt, device=dev),
        "ssm": torch.zeros((G, cfg.attn_every, batch, cfg.n_heads, P, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((G, cfg.attn_every, batch, CONV_K - 1,
                             d_inner + 2 * cfg.ssm_state), dtype=dt, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params: Zamba, batch, cache, cfg: ArchConfig, *, ring: bool = False):
    """One-token decode -> (logits, new_cache); see the module docstring for
    what is written in place and what is new."""
    h = rnn.embedding(params.embed, batch["tokens"], cfg.vocab, cfg.d_model)
    sp = params.shared
    pos = cache["pos"]
    ssm, conv = torch.empty_like(cache["ssm"]), torch.empty_like(cache["conv"])
    for g, group in enumerate(params.mamba_layers):
        layer_cache = {"k": cache["k"][g], "v": cache["v"][g], "pos": pos}
        a, _ = rnn.attention_decode(
            sp.attn, rnn.rmsnorm(sp.ln_attn, h), layer_cache,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, ring=ring, use_flash=cfg.use_flash)
        h = h + a
        h = h + rnn.mlp(sp.mlp, rnn.rmsnorm(sp.ln_mlp, h), kind="swiglu")
        for j, lp in enumerate(group):
            y, new = rnn.mamba2_decode(
                lp.mamba, rnn.rmsnorm(lp.ln, h),
                {"ssm": cache["ssm"][g, j], "conv": cache["conv"][g, j]},
                n_heads=cfg.n_heads, d_state=cfg.ssm_state)
            h = h + y
            ssm[g, j] = new["ssm"]
            conv[g, j] = new["conv"]
    h = rnn.rmsnorm(params.ln_f, h)
    logits = lm_head(params, h, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "ssm": ssm, "conv": conv,
                    "pos": pos + 1}
