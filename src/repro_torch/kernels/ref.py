"""Plain PyTorch versions of the attention kernels (the counterparts of
``repro/kernels/ref.py``). ``kernels.ops`` runs these for CPU tensors, and
the chip smoke test holds each CUDA kernel against them on the card."""
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
