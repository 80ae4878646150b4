"""Cross-entropy LM loss with label masking and MoE aux-loss folding (port
of ``repro/train/loss.py``).

``chunked_lm_head_loss`` fuses the lm_head projection into the loss one
sequence chunk at a time, each chunk under ``torch.utils.checkpoint``: the
full [B, S, V] logits tensor never materialises, and at most one
[B, chunk, V] block is live in the forward pass and, recomputed, in the
backward pass (the reference's ``jax.checkpoint`` inside a ``lax.scan``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.linear import linear


def _nll_sum(logits, labels):
    """(Σ masked NLL, valid count) of logits [..., V] and labels [...]
    (-100 = ignore), in f32."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(torch.where(valid, nll, 0.0)), torch.sum(valid, dtype=torch.int32)


def lm_loss(logits, labels, *, mask=None, lb_loss=None, lb_coeff: float = 0.01):
    """logits [B, S, V]; labels [B, S] (-100 = ignore); returns (loss, metrics)."""
    if mask is not None:
        labels = torch.where(mask, labels, -100)
    tot, cnt = _nll_sum(logits, labels)
    denom = torch.clamp(cnt, min=1)
    loss = tot / denom
    total = loss if lb_loss is None else loss + lb_coeff * lb_loss
    return total, {"ce_loss": loss, "n_tokens": denom}


def chunked_lm_head_loss(head, h, labels, *, lb_loss=None, lb_coeff: float = 0.01,
                         chunk: int = 512):
    """h [B, S, d] (post-final-norm), ``head`` = the lm_head ``Linear``,
    labels [B, S] (-100 = ignore) -> (loss, metrics). Sequence-chunked and
    recomputed, so at most one [B, chunk, V] logits block is live; a
    sequence that is no longer than ``chunk``, or no multiple of it, takes
    ``lm_loss`` over the whole logits."""
    B, S, d = h.shape
    if S <= chunk or S % chunk:
        return lm_loss(linear(head, h), labels, lb_loss=lb_loss, lb_coeff=lb_coeff)

    def body(h_k, y_k):
        return _nll_sum(linear(head, h_k), y_k)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for k0 in range(0, S, chunk):
        s, c = checkpoint(body, h[:, k0:k0 + chunk], labels[:, k0:k0 + chunk],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    denom = torch.clamp(cnt, min=1)
    loss = tot / denom
    total = loss if lb_loss is None else loss + lb_coeff * lb_loss
    return total, {"ce_loss": loss, "n_tokens": denom}
