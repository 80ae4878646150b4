"""Grouped-query attention: prefill (full-causal or sliding-window) and
single-token decode against a KV cache (contiguous or ring-buffer window).

Shapes:
    x           [B, S, d_model]
    q           [B, S, n_heads, head_dim]
    k/v         [B, S, n_kv, head_dim]
    cache k/v   [B, C, n_kv, head_dim]  (C = max context or window size)

On a CUDA tensor both attention functions run the Hopper kernels through
``kernels.ops`` whatever ``use_flash`` says. On the CPU ``use_flash`` picks
the kernels' plain versions (``kernels.ops``) or ``_sdpa``, as in the
reference, so the CPU parity tests line up one to one.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.nn.linear import Linear, linear
from repro_torch.nn.rope import apply_rope, rope_frequencies


class Attention(nn.Module):
    def __init__(self, dim: int, n_heads: int, n_kv: int, head_dim: int, *,
                 dtype=torch.float32, qkv_bias: bool = False, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = Linear(dim, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = Linear(dim, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wv = Linear(dim, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wo = Linear(n_heads * head_dim, dim, **kw)


def _qkv(params: Attention, x, n_heads: int, n_kv: int, head_dim: int):
    B, S, _ = x.shape
    q = linear(params.wq, x).reshape(B, S, n_heads, head_dim)
    k = linear(params.wk, x).reshape(B, S, n_kv, head_dim)
    v = linear(params.wv, x).reshape(B, S, n_kv, head_dim)
    return q, k, v


def _sdpa(q, k, v, mask):
    """q [B,S,H,D]; k,v [B,T,Hkv,D]; mask broadcastable to [B,Hkv,g,S,T],
    bool = keep."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, S, Hkv, group, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32),
                          k.to(torch.float32)) / (D ** 0.5)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


_NEG = -1e30            # finite -inf stand-in, as in the reference


def _sdpa_blocked(q, k, v, *, window=None, kv_chunk: int = 1024):
    """Causal GQA attention without the [S, S] tensor: a loop over KV chunks
    carries the online-softmax state (m, l, acc), so long prefills hold
    O(S·chunk) instead of O(S²). Plain torch, reached on the CPU only (a
    CUDA tensor takes the flash kernel). q [B,S,H,D]; k,v [B,T,Hkv,D]."""
    B, S, H, D = q.shape
    T = k.shape[1]
    Hkv = k.shape[2]
    g = H // Hkv
    chunk = min(kv_chunk, T)
    if T % chunk:
        raise ValueError(f"kv length {T} is not a multiple of chunk {chunk}")
    qf = q.to(torch.float32) / (D ** 0.5)
    iq = torch.arange(S, device=q.device)
    m = torch.full((B, S, H), _NEG, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, T, chunk):
        kr = k[:, j0:j0 + chunk].to(torch.float32).repeat_interleave(g, dim=2)
        vr = v[:, j0:j0 + chunk].to(torch.float32).repeat_interleave(g, dim=2)
        logits = torch.einsum("bshd,bchd->bshc", qf, kr)          # [B,S,H,C]
        jk = j0 + torch.arange(chunk, device=q.device)
        keep = jk[None, :] <= iq[:, None]                         # causal
        if window is not None:
            keep &= jk[None, :] > iq[:, None] - window
        logits = logits.masked_fill(~keep[None, :, None, :], _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        lsum = lsum * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bshc,bchd->bshd", p, vr)
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.to(q.dtype)


def attention_prefill(params: Attention, x, *, n_heads: int, n_kv: int,
                      head_dim: int, rope_theta: float | None = 10000.0,
                      window: int | None = None, positions=None,
                      use_flash: bool = False, blocked_threshold: int = 4096):
    """Causal self-attention over a full sequence. Returns (out, (k, v)).
    On the CPU, sequences longer than ``blocked_threshold`` stream through
    the blocked online-softmax path (no [S, S] materialisation)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    if rope_theta is not None:
        inv = rope_frequencies(head_dim, theta=rope_theta, device=x.device)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
    if use_flash or x.device.type == "cuda":
        out = kops.flash_attention(q, k.contiguous(), v.contiguous(),
                                   causal=True, window=window)
    elif S > blocked_threshold and S % 1024 == 0:
        out = _sdpa_blocked(q, k, v, window=window)
    else:
        idx = torch.arange(S, device=x.device)
        mask = idx[None, :] <= idx[:, None]            # causal
        if window is not None:
            mask = mask & (idx[None, :] > idx[:, None] - window)
        out = _sdpa(q, k, v, mask[None, None, None, :, :])
    out = out.reshape(B, S, n_heads * head_dim)
    return linear(params.wo, out), (k, v)


def make_kv_cache(batch: int, context: int, n_kv: int, head_dim: int, *,
                  dtype=torch.float32, device="cpu"):
    sh = (batch, context, n_kv, head_dim)
    return {"k": torch.zeros(sh, dtype=dtype, device=device),
            "v": torch.zeros(sh, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def attention_decode(params: Attention, x, cache, *, n_heads: int, n_kv: int,
                     head_dim: int, rope_theta: float | None = 10000.0,
                     ring: bool = False, use_flash: bool = False):
    """One-token decode. x [B, 1, d]. cache entries [B, C, kv, hd].

    ``ring=True`` treats the cache as a sliding-window ring buffer (writes
    wrap); otherwise positions index the cache contiguously, and once the
    cache is full the last slot is overwritten. Returns (out, new_cache).

    Unlike the reference, the new k/v slot is written IN PLACE into
    ``cache["k"]`` / ``cache["v"]`` (no copy of the [B, C, kv, hd] buffers);
    the returned dict holds those same tensors and ``pos + 1``.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    C = cache["k"].shape[1]
    pos = cache["pos"]                                   # [B]
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim)
    if rope_theta is not None:
        inv = rope_frequencies(head_dim, theta=rope_theta, device=x.device)
        q = apply_rope(q, pos[:, None], inv)
        k = apply_rope(k, pos[:, None], inv)
    slot = (pos % C) if ring else torch.clamp(pos, max=C - 1)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    # valid slots: contiguous -> [0, pos]; ring -> min(pos+1, C) most recent
    n_valid = torch.clamp(pos + 1, max=C)                # [B]
    mask = torch.arange(C, device=x.device)[None, :] < n_valid[:, None]  # [B, C]
    if use_flash or x.device.type == "cuda":
        out = kops.decode_attention(q, cache["k"], cache["v"], mask)
    else:
        out = _sdpa(q, cache["k"], cache["v"], mask[:, None, None, None, :])
    out = out.reshape(B, 1, n_heads * head_dim)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return linear(params.wo, out), new_cache


def init_cross_attention(dim: int, n_heads: int, head_dim: int, *,
                         dtype=torch.float32, device="cpu",
                         generator: torch.Generator | None = None) -> Attention:
    return Attention(dim, n_heads, n_heads, head_dim, dtype=dtype, qkv_bias=True,
                     device=device, generator=generator)


def cross_attention(params: Attention, x, enc, *, n_heads: int, head_dim: int):
    """x [B,S,d] attends to encoder states enc [B,T,d] (no mask, no rope).
    Plain ``_sdpa`` on every device, as in the reference."""
    B, S, _ = x.shape
    T = enc.shape[1]
    q = linear(params.wq, x).reshape(B, S, n_heads, head_dim)
    k = linear(params.wk, enc).reshape(B, T, n_heads, head_dim)
    v = linear(params.wv, enc).reshape(B, T, n_heads, head_dim)
    mask = torch.ones((1, 1, 1, S, T), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask).reshape(B, S, n_heads * head_dim)
    return linear(params.wo, out)
