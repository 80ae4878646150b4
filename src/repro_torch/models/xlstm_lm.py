"""xLSTM LM (ssm family): a stack of mLSTM blocks with every
``slstm_every``-th layer an sLSTM block. Port of ``repro/models/xlstm_lm.py``.

The cache is the recurrent state alone, one dict per layer, as the
reference lays it out; a decode step returns new state tensors and leaves
the ones it was given untouched.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import nn as rnn
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig


def is_slstm(cfg: ArchConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and (i + 1) % cfg.slstm_every == 0


class XLSTMLayer(nn.Module):
    """``ln`` plus one of ``slstm`` / ``mlstm``, under the reference's names."""

    def __init__(self, cfg: ArchConfig, slstm: bool, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.ln = rnn.RMSNorm(cfg.d_model, dtype=dt, device=device)
        if slstm:
            self.slstm = rnn.SLSTM(cfg.d_model, cfg.n_heads, **kw)
        else:
            self.mlstm = rnn.MLSTM(cfg.d_model, cfg.n_heads, **kw)


class XLSTMLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device, generator):
        super().__init__()
        dt = cfg.param_dtype
        self.embed = rnn.Embedding(cfg.vocab, cfg.d_model, dtype=dt, device=device,
                                   generator=generator)
        self.layers = nn.ModuleList(
            XLSTMLayer(cfg, is_slstm(cfg, i), device=device, generator=generator)
            for i in range(cfg.n_layers))
        self.ln_f = rnn.RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.lm_head = rnn.Linear(cfg.d_model, cfg.vocab, dtype=dt, device=device,
                                  generator=generator)


def init_model(seed: int, cfg: ArchConfig, *, device="cuda") -> XLSTMLM:
    """Random weights from ``seed`` on ``device`` with the reference's
    distributions; parity tests copy the JAX weights in."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return XLSTMLM(cfg, device=dev, generator=gen)


def _aux(h):
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return {"lb_loss": zero, "dropped_frac": zero}


def forward(params: XLSTMLM, batch, cfg: ArchConfig, *, window=None, shard_h=None,
            last_only: bool = False, return_hidden: bool = False):
    """tokens [B, S] -> (logits, aux). ``window``, ``shard_h`` and
    ``cfg.remat`` are accepted and ignored, as the dense family does."""
    h = rnn.embedding(params.embed, batch["tokens"])
    for i, lp in enumerate(params.layers):
        x = rnn.rmsnorm(lp.ln, h)
        if is_slstm(cfg, i):
            h = h + rnn.slstm_scan(lp.slstm, x, n_heads=cfg.n_heads)
        else:
            # chunkwise form: O(S*chunk) memory instead of O(S^2)
            h = h + rnn.mlstm_chunkwise(lp.mlstm, x, n_heads=cfg.n_heads)
    if last_only:
        h = h[:, -1:]
    h = rnn.rmsnorm(params.ln_f, h)
    if return_hidden:
        return h, _aux(h)
    return rnn.linear(params.lm_head, h), _aux(h)


def init_cache(cfg: ArchConfig, batch: int, context: int, *, dtype=None, device="cuda"):
    """Per-layer recurrent state (f32, whatever the weights' dtype) + pos."""
    dev = resolve_device(device)
    states = [rnn.make_slstm_state(batch, cfg.d_model, cfg.n_heads, device=dev)
              if is_slstm(cfg, i) else
              rnn.make_mlstm_state(batch, cfg.d_model, cfg.n_heads, device=dev)
              for i in range(cfg.n_layers)]
    return {"states": states, "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def decode_step(params: XLSTMLM, batch, cache, cfg: ArchConfig, *, ring: bool = False):
    h = rnn.embedding(params.embed, batch["tokens"])
    new_states = []
    for i, (lp, st) in enumerate(zip(params.layers, cache["states"], strict=True)):
        x = rnn.rmsnorm(lp.ln, h)
        if is_slstm(cfg, i):
            y, new = rnn.slstm_decode(lp.slstm, x, st, n_heads=cfg.n_heads)
        else:
            y, new = rnn.mlstm_decode(lp.mlstm, x, st, n_heads=cfg.n_heads)
        h = h + y
        new_states.append(new)
    h = rnn.rmsnorm(params.ln_f, h)
    logits = rnn.linear(params.lm_head, h)
    return logits, {"states": new_states, "pos": cache["pos"] + 1}
