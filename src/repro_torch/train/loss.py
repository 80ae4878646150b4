"""Cross-entropy LM loss with label masking and MoE aux-loss folding (port
of ``repro/train/loss.py``).

``chunked_lm_head_loss`` fuses the lm_head projection into the loss one
sequence chunk at a time, each chunk under ``torch.utils.checkpoint``: the
full [B, S, V] logits tensor never materialises, and at most one
[B, chunk, V] block is live in the forward pass and, recomputed, in the
backward pass (the reference's ``jax.checkpoint`` inside a ``lax.scan``).

Under a running mesh (``distributed.collectives``) the ``lm_head`` may be
this rank's vocab block ``[d, V/M]``: each chunk's ``[B, chunk, V/M]``
logits stay split, and the log-softmax is taken across the ranks (the
row max over "model", detached, then the sum of exponentials and the
target's logit, each one ``psum`` over "model"). The normaliser is global:
the valid-token count is summed over the batch axes, and each rank's loss
term is its own NLL sum over that count, so the terms add up to the
one-rank loss however the ``-100`` labels fall; the ``metrics`` report the
global values. A term every data rank holds whole (the MoE ``lb_loss``,
whose sums ``nn.moe`` adds over the batch axes) enters each rank's term
once: its backward on a rank is that rank's part of the gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as col
from repro_torch.nn.linear import linear, linear_cols, linear_rows


def _nll_sum(logits, labels):
    """(Σ masked NLL, valid count) of logits [..., V] and labels [...]
    (-100 = ignore), in f32."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(torch.where(valid, nll, 0.0)), torch.sum(valid, dtype=torch.int32)


def _nll_sum_split(logits, labels):
    """``_nll_sum`` of this rank's vocab block of the logits [..., V/M]:
    the log-softmax across the ranks of "model" (module docstring)."""
    valid = labels >= 0
    z = logits.to(torch.float32)
    Vl = z.shape[-1]
    top = col.pmax(z.detach().amax(dim=-1), "model")
    sumexp = col.psum(torch.exp(z - top[..., None]).sum(dim=-1), "model")
    local = labels.long() - col.index("model") * Vl
    hit = valid & (local >= 0) & (local < Vl)
    picked = torch.gather(z, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    target = col.psum(torch.where(hit, picked, 0.0), "model")
    nll = torch.log(sumexp) + top - target
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
                         chunk: int = 512, vocab: int | None = None):
    """h [B, S, d] (post-final-norm), ``head`` = the lm_head ``Linear``,
    labels [B, S] (-100 = ignore) -> (loss, metrics). Sequence-chunked and
    recomputed, so at most one [B, chunk, V] logits block is live; a
    sequence that is no longer than ``chunk``, or no multiple of it, takes
    ``lm_loss`` over the whole logits. ``vocab`` (the whole vocabulary)
    tells a rank's vocab block of ``head`` from a whole one. On a running
    mesh ``loss`` is this rank's term and ``metrics`` hold the global
    ``ce_loss`` and ``n_tokens`` (module docstring)."""
    B, S, d = h.shape
    split = vocab is not None and head.w.shape[1] < vocab
    if col.current_mesh() is None and (S <= chunk or S % chunk):
        return lm_loss(linear(head, h), labels, lb_loss=lb_loss, lb_coeff=lb_coeff)

    nll_sum = _nll_sum_split if split else _nll_sum

    def body(h_k, y_k):
        if head.w.shape[0] < d:                         # d_model rows over "model"
            return nll_sum(linear_rows(head, h_k, d), y_k)
        return nll_sum(linear_cols(head, h_k, vocab or head.w.shape[1], gather=False), y_k)

    if S <= chunk or S % chunk:
        tot, cnt = body(h, labels)
    else:
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int32, device=h.device)
        for k0 in range(0, S, chunk):
            s, c = checkpoint(body, h[:, k0:k0 + chunk], labels[:, k0:k0 + chunk],
                              use_reentrant=False)
            tot, cnt = tot + s, cnt + c
    rows = col.batch_axes()
    denom = torch.clamp(col.psum(cnt, rows), min=1)
    loss = tot / denom
    ce = col.psum(loss.detach(), rows) if rows else loss
    total = loss if lb_loss is None else loss + lb_coeff * lb_loss
    return total, {"ce_loss": ce, "n_tokens": denom}
