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
reference, so the CPU parity tests line up one to one. The kernels have no
backward, as the Pallas kernels have none: the train step asks prefill for
``sdpa=True``, the reference's ``use_flash=False`` computation, on every
device.

Under a running mesh (``distributed.collectives``) a rank holds the block
of ``wq`` (and ``wk``/``wv`` when the kv heads divide) that the rules give
it: its local query heads, read off the weights' widths. Prefill runs over
the local heads and the kv heads they use, and ``wo`` (a row block) sums
over "model". Decode over a cache whose length C is split over "model"
(``collectives.cache_axes``) is flash-decoding across ranks: q and the new
token's k/v are gathered (a few KB), the rank that owns slot ``pos``
writes it, every rank runs the decode kernel over its own C/M slots for
every head and returns out and log-sum-exp, and the ranks' partials merge
with one ``pmax`` and one ``psum``; each rank keeps its heads' slice for
``wo``. A whole cache is written whole on every rank.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import collectives as col
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, acc_dtype
from repro_torch.nn.linear import Linear, linear, linear_rows, linear_shared
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
    """q [B, S, Hq, hd], k/v [B, S, Hk, hd]: Hq and Hk are the heads this
    rank's ``wq`` and ``wk`` hold (all of them off a mesh). A rank holding
    a block of the query heads takes ``x`` through ``collectives.copy``,
    and whole ``wk``/``wv`` (kv heads that do not divide) through
    ``linear_shared``: each rank uses them for its own heads."""
    B, S, _ = x.shape
    split = params.wq.w.shape[1] < n_heads * head_dim
    if split:
        x = col.copy(x, "model")
    kv = (linear_shared if split and params.wk.w.shape[1] == n_kv * head_dim else linear)
    q = linear(params.wq, x).reshape(B, S, -1, head_dim)
    k = kv(params.wk, x).reshape(B, S, -1, head_dim)
    v = kv(params.wv, x).reshape(B, S, -1, head_dim)
    return q, k, v


def _kv_for_heads(k, v, Hq: int, n_heads: int, n_kv: int):
    """The kv heads (dim 2) that this rank's Hq query heads use, grouped as
    GQA takes them. Only a rank holding a block of the query heads over
    whole kv heads (starcoder2: Hkv = 2 on M = 4) selects; otherwise the
    local heads are already a matching block."""
    if Hq == n_heads or k.shape[2] != n_kv:
        return k, v
    g = n_heads // n_kv
    h0 = col.index("model") * Hq
    if g % Hq == 0 or Hq % g == 0:
        sel = slice(h0 // g, h0 // g + max(1, Hq // g))
        return k[:, :, sel], v[:, :, sel]
    idx = (h0 + torch.arange(Hq, device=k.device)) // g       # one kv head per q head
    return k[:, :, idx], v[:, :, idx]


def _sdpa(q, k, v, mask):
    """q [B,S,H,D]; k,v [B,T,Hkv,D]; mask broadcastable to [B,Hkv,g,S,T],
    bool = keep."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, S, Hkv, group, D)
    acc = acc_dtype(q)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.to(acc), k.to(acc)) / (D ** 0.5)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(acc))
    return out.reshape(B, S, H, D).to(q.dtype)


_NEG = -1e30            # finite -inf stand-in, as in the reference


def _sdpa_blocked(q, k, v, *, window=None, kv_chunk: int = 1024):
    """Causal GQA attention without the [S, S] tensor: a loop over KV chunks
    carries the online-softmax state (m, l, acc), so long prefills hold
    O(S·chunk) instead of O(S²). Plain torch, reached on the CPU and, on
    any device, by ``attention_prefill(sdpa=True)``. q [B,S,H,D];
    k,v [B,T,Hkv,D]."""
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
                      use_flash: bool = False, blocked_threshold: int = 4096,
                      sdpa: bool = False):
    """Causal self-attention over a full sequence. Returns (out, (k, v)).
    ``sdpa=True`` computes the reference's ``use_flash=False`` attention on
    every device, the differentiable path the train step takes; otherwise
    a CUDA tensor launches the flash kernel. On that path sequences longer
    than ``blocked_threshold`` stream through the blocked online-softmax
    path (no [S, S] materialisation)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim)
    Hq = q.shape[2]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    if rope_theta is not None:
        inv = rope_frequencies(head_dim, theta=rope_theta, device=x.device)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
    ku, vu = _kv_for_heads(k, v, Hq, n_heads, n_kv)
    if not sdpa and (use_flash or x.device.type == "cuda"):
        out = kops.flash_attention(q, ku.contiguous(), vu.contiguous(),
                                   causal=True, window=window)
    elif S > blocked_threshold and S % 1024 == 0:
        out = _sdpa_blocked(q, ku, vu, window=window)
    else:
        idx = torch.arange(S, device=x.device)
        mask = idx[None, :] <= idx[:, None]            # causal
        if window is not None:
            mask = mask & (idx[None, :] > idx[:, None] - window)
        out = _sdpa(q, ku, vu, mask[None, None, None, :, :])
    out = out.reshape(B, S, Hq * head_dim)
    return linear_rows(params.wo, out, n_heads * head_dim), (k, v)


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
    pos = cache["pos"]                                   # [B]
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim)
    Hq = q.shape[2]
    if rope_theta is not None:
        inv = rope_frequencies(head_dim, theta=rope_theta, device=x.device)
        q = apply_rope(q, pos[:, None], inv)
        k = apply_rope(k, pos[:, None], inv)
    if k.shape[2] != n_kv:                               # the cache holds every kv head
        k, v = col.gather(k, "model", 2), col.gather(v, "model", 2)
    Cl = cache["k"].shape[1]                             # this rank's slots
    split = "model" in col.cache_axes()
    C = Cl * col.span("model") if split else Cl
    lo = col.index("model") * Cl if split else 0
    slot = (pos % C) if ring else torch.clamp(pos, max=C - 1)
    bidx = torch.arange(B, device=x.device)
    if split:       # only the owner of slot ``pos`` writes; the others rewrite a slot as is
        own = ((slot >= lo) & (slot < lo + Cl))[:, None, None]
        slot = torch.clamp(slot - lo, 0, Cl - 1)
        k = torch.where(own, k[:, 0].to(cache["k"].dtype), cache["k"][bidx, slot])[:, None]
        v = torch.where(own, v[:, 0].to(cache["v"].dtype), cache["v"][bidx, slot])[:, None]
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    # valid slots: contiguous -> [0, pos]; ring -> min(pos+1, C) most recent
    n_valid = torch.clamp(pos + 1, max=C)                # [B]
    mask = lo + torch.arange(Cl, device=x.device)[None, :] < n_valid[:, None]  # [B, Cl]
    if split:
        out = _decode_merged(q, cache["k"], cache["v"], mask, n_heads)
    else:
        ck, cv = _kv_for_heads(cache["k"], cache["v"], Hq, n_heads, n_kv)
        if use_flash or x.device.type == "cuda":
            out = kops.decode_attention(q, ck.contiguous(), cv.contiguous(), mask)
        else:
            out = _sdpa(q, ck, cv, mask[:, None, None, None, :])
    out = out.reshape(B, 1, Hq * head_dim)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return linear_rows(params.wo, out, n_heads * head_dim), new_cache


def _decode_merged(q, ck, cv, mask, n_heads: int):
    """Decode attention over a cache whose slots are split over "model":
    every head over this rank's slots, merged across the ranks by
    log-sum-exp -> this rank's heads [B, 1, Hq, D] in q's dtype."""
    B, _, Hq, D = q.shape
    qa = col.gather(q, "model", 2) if Hq < n_heads else q
    out, lse = kops.decode_attention(qa, ck, cv, mask, return_lse=True)
    top = col.pmax(lse, "model")                           # [B, H]: some rank has a slot
    w = torch.exp(lse - top)                               # 0 where lse = -inf
    part = torch.cat([(out.to(w.dtype) * w[:, None, :, None]).reshape(B, -1), w], 1)
    tot = col.psum(part, "model")
    num = tot[:, :n_heads * D].reshape(B, 1, n_heads, D)
    merged = (num / tot[:, n_heads * D:][:, None, :, None]).to(q.dtype)
    return col.block(merged, "model", 2) if Hq < n_heads else merged


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
