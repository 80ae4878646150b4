"""Plain PyTorch versions of the kernels (for attention the counterparts of
``repro/kernels/ref.py``; the MoE combine has no Pallas kernel).
``kernels.ops`` runs these for CPU tensors, and the chip smoke test holds
each CUDA kernel against them on the card."""
from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions and the layers compute in: float32 for
    bf16 and f32 inputs, as the reference does, and float64 for a float64
    input (a precision check's reference run)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """q [B, S, H, D]; k, v [B, S, Hkv, D] -> [B, S, H, D] (f32 math; f64
    for f64 inputs)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    acc = acc_dtype(q)
    qg = q.reshape(B, S, Hkv, g, D).to(acc)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k.to(acc)) / (D ** 0.5)
    idx = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = idx[None, :] <= idx[:, None]
    if window is not None:
        mask = mask & (idx[None, :] > idx[:, None] - window)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(acc))
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention_ref(q, k, v, valid_mask, *, return_lse: bool = False):
    """q [B, 1, H, D]; k, v [B, C, Hkv, D]; valid_mask [B, C] -> [B, 1, H, D]
    (a row with no valid slot: the mean of V). With ``return_lse`` ->
    (out, lse [B, H] f32, f64 for f64 inputs): the log-sum-exp of the scaled logits over the
    valid slots, and a row with no valid slot gives out = 0, lse = -inf."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    acc = acc_dtype(q)
    qg = q.reshape(B, 1, Hkv, g, D).to(acc)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k.to(acc)) / (D ** 0.5)
    mask = valid_mask[:, None, None, None, :]
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(acc)).reshape(B, 1, H, D)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(logits.masked_fill(~mask, -torch.inf), dim=-1).reshape(B, H)
    empty = ~valid_mask.any(dim=1)
    out = out.masked_fill(empty[:, None, None, None], 0.0)
    return out.to(q.dtype), lse


def moe_combine_ref(ye, gsel, slot_of, *, out_dtype=None):
    """ye [B, E, C, d], gsel [B, E, C] f32, slot_of [B, E, S] int32 (the slot
    that token s holds in expert e, or -1) -> y [B, S, d] in ``out_dtype``
    (default ye's dtype). The CUDA kernel's arithmetic in its order: each
    term is the reference's ``ye * to(ye.dtype, gsel)`` in ye's dtype, the
    terms of a token are added in ascending e in float32 (float64 for a
    float64 ye), then rounded once. A slot of -1 adds nothing (the kernel
    skips it; adding +0.0 to a sum that started at +0.0 changes no bit)."""
    B, E, C, d = ye.shape
    S = slot_of.shape[2]
    acc = torch.promote_types(ye.dtype, torch.float32)
    gated = ye * (gsel * (gsel > 0))[..., None].to(ye.dtype)
    rows = torch.arange(B, device=ye.device)[:, None]
    y = torch.zeros((B, S, d), dtype=acc, device=ye.device)
    for e in range(E):
        slot = slot_of[:, e].long()
        term = gated[rows, e, slot.clamp(min=0)].to(acc)                  # [B,S,d]
        y = y + torch.where((slot >= 0)[..., None], term, 0.0)
    return y.to(ye.dtype if out_dtype is None else out_dtype)


def moe_combine_grad(dy, ye, gsel, slot_of):
    """(d ye, d gsel) of ``moe_combine_ref`` for the output's gradient dy
    [B, S, d]: each used slot takes its token's row of dy, cast to ye's dtype
    as the output's cast passes it back."""
    B, E, C, d = ye.shape
    S = slot_of.shape[2]
    used = slot_of >= 0
    # tok[b, e, c]: the token that holds slot c, or S (a zero row of dy)
    tok = torch.full((B, E, C + 1), S, dtype=torch.long, device=ye.device)
    tok.scatter_(2, torch.where(used, slot_of, C).long(),
                 torch.arange(S, device=ye.device).expand(B, E, S))
    rows = torch.arange(B, device=ye.device)[:, None, None]
    dyt = torch.cat([dy.to(ye.dtype), dy.new_zeros((B, 1, d), dtype=ye.dtype)], 1)
    dyt = dyt[rows, tok[..., :C]]                                          # [B,E,C,d]
    live = gsel > 0
    dye = dyt * (gsel * live)[..., None].to(ye.dtype)
    dgsel = (dyt * ye).sum(-1).to(gsel.dtype) * live
    return dye, dgsel
