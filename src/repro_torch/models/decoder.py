"""Decoder-only LM covering the dense, moe and vlm families.

The reference stacks per-layer parameters on a leading [L, ...] axis and
``lax.scan``s them; here the layers are an ``nn.ModuleList`` walked by a
Python loop. With the MoE interleave (``moe_every`` > 1, llama4) an entry
of ``layers`` is a ``Block`` of ``moe_every`` sub-layers ``sub0..``, the
last one MoE, as the reference's scanned block. The KV cache stays
stacked, ``[L, B, C, kv, hd]`` plus ``pos [B]``, as the reference's
``init_cache`` lays it out. The vlm family prepends the projected vision
embeddings ``vision_embeds [B, P, d]`` to the token embeddings.

Under a running mesh (``distributed.collectives``) each rank holds its
blocks (``distributed.sharding.place``) and the layers run the sharded
program: column/row-parallel attention, MLP and ``lm_head``,
expert-parallel MoE, a vocab- or width-split embedding, the vlm's
column-split ``vis_proj`` (gathered, then prepended to the tokens), and,
with ``shard_h``, the sequence-parallel residual stream over every
position (the vlm's patches and tokens), whose block each layer gathers
before it attends. A collected cache holds every kv head and the rank's
block of the P + S slots. The logits come back whole for the
rank's batch rows, or, with ``vocab_block``, as the rank's block of a
vocab-split ``lm_head`` (the train step's loss and the prefill's last
position take it so). Under grad every collective carries its transpose
(``distributed.collectives``), so the sharded program differentiates to
the one-rank program's gradients.

With ``cfg.remat`` and grad enabled each entry of ``layers`` (its body
with ``shard_h``, as the reference's checkpointed scan body) runs under
``models.remat.layer``: its activations are recomputed in the backward.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import nn as rnn
from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.models import remat
from repro_torch.models.config import ArchConfig


def _norm_fns(cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return rnn.LayerNorm, rnn.layernorm
    return rnn.RMSNorm, rnn.rmsnorm


def _block_k(cfg: ArchConfig) -> int:
    """Layers per scanned block in the reference: >1 when MoE is interleaved
    (llama4's interleave_moe_layer_step: sub-layers 0..k-2 dense, k-1 MoE)."""
    return cfg.moe_every if (cfg.n_experts and cfg.moe_every > 1) else 1


class Layer(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp`` and one of ``moe`` / ``mlp``."""

    def __init__(self, cfg: ArchConfig, *, use_moe: bool, device, generator):
        super().__init__()
        Norm, _ = _norm_fns(cfg)
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.ln_attn = Norm(cfg.d_model, dtype=dt, device=device)
        self.attn = rnn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                  qkv_bias=cfg.norm == "layernorm", **kw)
        self.ln_mlp = Norm(cfg.d_model, dtype=dt, device=device)
        if use_moe:
            self.moe = rnn.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, **kw)
        else:
            self.mlp = rnn.MLP(cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind, **kw)


class Block(nn.Module):
    """One interleave block: ``sub0 .. sub{k-1}``, the last one MoE."""

    def __init__(self, cfg: ArchConfig, k: int, *, device, generator):
        super().__init__()
        for i in range(k):
            self.add_module(f"sub{i}", Layer(cfg, use_moe=i == k - 1, device=device,
                                             generator=generator))


class DecoderLM(nn.Module):
    """Parameters of one decoder-only LM under the reference's names:
    ``embed``, ``layers`` (one ``Layer`` per depth, or one ``Block`` per
    interleave block), ``ln_f``, ``lm_head`` and, for vlm, ``vis_proj``."""

    # the reference stacks ``layers`` on one leading axis ([L, ...] or [n_blocks, ...])
    stacked_layers = {"layers": 1}

    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        Norm, _ = _norm_fns(cfg)
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.embed = rnn.Embedding(cfg.vocab, cfg.d_model, **kw)
        k = _block_k(cfg)
        if k == 1:
            self.layers = nn.ModuleList(
                Layer(cfg, use_moe=cfg.n_experts > 0, device=device, generator=generator)
                for _ in range(cfg.n_layers))
        else:
            if cfg.n_layers % k:
                raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a multiple "
                                 f"of moe_every {k}")
            self.layers = nn.ModuleList(Block(cfg, k, device=device, generator=generator)
                                        for _ in range(cfg.n_layers // k))
        self.ln_f = Norm(cfg.d_model, dtype=dt, device=device)
        self.lm_head = rnn.Linear(cfg.d_model, cfg.vocab, **kw)
        if cfg.family == "vlm":
            # projector stub: vision embeddings arrive pre-projected at d_model
            self.vis_proj = rnn.Linear(cfg.d_model, cfg.d_model, **kw)


def _sub_layers(cfg: ArchConfig, lp):
    """[(layer, use_moe)] of one entry of ``layers``."""
    k = _block_k(cfg)
    if k == 1:
        return [(lp, cfg.n_experts > 0)]
    return [(getattr(lp, f"sub{i}"), i == k - 1) for i in range(k)]


def init_model(seed: int, cfg: ArchConfig, *, device="cuda") -> DecoderLM:
    """Random weights from ``seed`` on ``device``, with the reference's
    distributions (lecun-normal linears, 0.02 embedding, unit norms). The
    bits differ from ``jax.random``; parity tests copy the JAX weights in
    with ``models.convert.load_jax_params``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return DecoderLM(cfg, device=dev, generator=gen)


def embed_inputs(params: DecoderLM, batch, cfg: ArchConfig):
    """tokens [B, S] (+ vision_embeds [B, P, d] for vlm) -> h [B, S_total, d]."""
    h = rnn.embedding(params.embed, batch["tokens"], cfg.vocab, cfg.d_model)
    if cfg.family == "vlm":
        vis = rnn.linear_cols(params.vis_proj, batch["vision_embeds"].to(h.dtype),
                              cfg.d_model)
        h = torch.cat([vis, h], dim=1)
    return h


def lm_head(params: DecoderLM, h, cfg: ArchConfig, *, vocab_block: bool = False):
    """Logits [..., vocab] from a rank's whole ``lm_head`` or its block:
    vocab columns (gathered; with ``vocab_block`` the rank's [..., V/M]
    block is returned as is) or d_model rows (summed over "model")."""
    if params.lm_head.w.shape[0] < cfg.d_model:
        return rnn.linear_rows(params.lm_head, h, cfg.d_model)
    return rnn.linear_cols(params.lm_head, h, cfg.vocab, gather=not vocab_block)


def _zero_aux(device):
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": zero, "dropped_frac": zero}


def _mean_aux(auxs: list[dict]) -> dict:
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def forward(params: DecoderLM, batch, cfg: ArchConfig, *, window=None,
            shard_h=None, collect_cache: bool = False, last_only: bool = False,
            return_hidden: bool = False, sdpa: bool = False, vocab_block: bool = False):
    """Full-sequence forward -> (logits, aux[, cache]). ``last_only``
    computes logits for the final position only. aux is the mean over
    layers (and over an interleave block's sub-layers first, as the
    reference) of the MoE load-balance loss and dropped fraction, zero for
    a dense layer. ``sdpa`` goes to ``attention_prefill`` (the train
    step's differentiable attention). ``shard_h`` (``distributed.sharding
    .residual_constraint``) is applied to the residual stream after every
    entry of ``layers``, as the reference's scan body does; under a running
    mesh it keeps the rank's block of the sequence, which the next layer
    gathers. With ``cfg.remat`` and grad enabled each entry of ``layers``
    is recomputed in the backward (module docstring). ``vocab_block``
    returns a vocab-split ``lm_head``'s block of the logits ungathered. A
    collected cache is laid out as the cache rule places it."""
    h = embed_inputs(params, batch, cfg)
    B, S_total = h.shape[:2]
    _, norm = _norm_fns(cfg)
    ks, vs, auxs = [], [], []
    dense_aux = _zero_aux(h.device)

    def body(lp, h):
        sub_aux, sub_k, sub_v = [], [], []
        for sp, use_moe in _sub_layers(cfg, lp):
            if h.shape[1] != S_total:                     # a sequence block: gather it
                h = col.gather(h, "model", 1)
            tracing.mark("attention", h)
            a, (k, v) = rnn.attention_prefill(
                sp.attn, norm(sp.ln_attn, h),
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, window=window, use_flash=cfg.use_flash,
                sdpa=sdpa)
            h = h + a
            tracing.mark("moe" if use_moe else "mlp", h)
            x = norm(sp.ln_mlp, h)
            if use_moe:
                m, aux = rnn.moe(sp.moe, x, top_k=cfg.top_k)
            else:
                m, aux = rnn.mlp(sp.mlp, x, kind=cfg.mlp_kind), dense_aux
            h = h + m
            sub_aux.append(aux)
            if collect_cache:
                sub_k.append(k)
                sub_v.append(v)
        aux = sub_aux[0] if len(sub_aux) == 1 else _mean_aux(sub_aux)
        if shard_h is not None:
            h = shard_h(h)
        return h, aux, sub_k, sub_v

    for lp in params.layers:
        h, aux, sub_k, sub_v = remat.layer(cfg, body, lp, h)
        auxs.append(aux)
        ks.extend(sub_k)
        vs.extend(sub_v)
    tracing.mark("head", h)
    if h.shape[1] != S_total:
        h = col.gather(h, "model", 1)
    if last_only:
        h = h[:, -1:]
    h = norm(params.ln_f, h)
    aux = _mean_aux(auxs)
    if return_hidden:
        return h, aux
    logits = lm_head(params, h, cfg, vocab_block=vocab_block)
    if collect_cache:
        k, v = torch.stack(ks), torch.stack(vs)
        if k.shape[3] != cfg.n_kv:                      # the cache holds every kv head
            k, v = col.gather(k, "model", 3), col.gather(v, "model", 3)
        if S_total % col.span("model") == 0:            # and a block of its slots
            k, v = col.block(k, "model", 2).contiguous(), col.block(v, "model", 2).contiguous()
        cache = {"k": k, "v": v,
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
    Layer l (block-major through an interleave) writes its new k/v slot in
    place into ``cache["k"][l]`` / ``cache["v"][l]``; the returned cache
    holds the same tensors and ``pos + 1``."""
    h = rnn.embedding(params.embed, batch["tokens"], cfg.vocab, cfg.d_model)
    pos = cache["pos"]
    _, norm = _norm_fns(cfg)
    # 100B+ MoE decode keeps the expert weights resident, E x d_ff split
    # over ("model", "data"), and sums activations instead (the reference's)
    ep2d = cfg.n_experts > 0 and cfg.param_count() > 1e11
    layers = [sl for lp in params.layers for sl in _sub_layers(cfg, lp)]
    for i, (lp, use_moe) in enumerate(layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        a, _ = rnn.attention_decode(
            lp.attn, norm(lp.ln_attn, h), layer_cache,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, ring=ring, use_flash=cfg.use_flash)
        h = h + a
        x = norm(lp.ln_mlp, h)
        if use_moe:
            m, _ = rnn.moe(lp.moe, x, top_k=cfg.top_k, need_aux=False, ep2d=ep2d)
        else:
            m = rnn.mlp(lp.mlp, x, kind=cfg.mlp_kind)
        h = h + m
    h = norm(params.ln_f, h)
    logits = lm_head(params, h, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
