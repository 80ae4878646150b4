"""Plain reference of the audio family: the whisper decoder.

Learned positions from a 4,096-row table, then in every layer LayerNorm,
causal self-attention, cross-attention to the encoder's frames (a stub:
``enc_len`` rows of ``reference.stub_inputs``, seeded 1) and a tanh-GELU MLP,
all with biases; an untied head. Its layout, forward and counts follow
``src/repro_torch/models/whisper.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as R, weights as W

WHISPER_POSITIONS = 4096  # the whisper decoder's learned position table


def layout(arch: dict) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of every parameter, in the port's order."""
    dt = W.DTYPES[arch["dtype"]]
    d, h, f, v = (arch[k] for k in ("d_model", "n_heads", "d_ff", "vocab"))
    hd = d // h
    out = [("embed.e", (v, d), dt)]
    out.append(("pos.e", (WHISPER_POSITIONS, d), dt))
    for i in range(arch["n_layers"]):
        p = f"layers.{i}"
        out += W._norm(f"{p}.ln_self", d, True, dt)
        out += W._attention(f"{p}.self_attn", d, h, h, hd, True, dt)
        out += W._norm(f"{p}.ln_cross", d, True, dt)
        out += W._attention(f"{p}.cross_attn", d, h, h, hd, True, dt)
        out += W._norm(f"{p}.ln_mlp", d, True, dt)
        out += W._mlp(f"{p}.mlp", d, f, "gelu", dt)
    return out + W._norm("ln_f", d, True, dt) + [("lm_head.w", (d, v), dt)]


def _cross_attention(p, prefix, x, enc, arch):
    B, S, _ = x.shape
    hd = arch["d_model"] // arch["n_heads"]
    q = R._lin(p, f"{prefix}.wq", x).view(B, S, -1, hd)
    k = R._lin(p, f"{prefix}.wk", enc).view(B, enc.shape[1], -1, hd)
    v = R._lin(p, f"{prefix}.wv", enc).view(B, enc.shape[1], -1, hd)
    return R._lin(p, f"{prefix}.wo", R._attend(q, k, v, False))


def logits(arch: dict, seed: int, stage: int, variant: int, tokens: np.ndarray,
           batch_rows: list[tuple[int, int]], device, quant: str | None = None):
    """Reference logits [k, S, vocab] (f32); ``reference.logits`` says more."""
    dt = W.DTYPES[arch["dtype"]]
    params = layout(arch)

    def group(i):
        return R._weights(arch, seed, stage, variant, i, device, quant, params)

    L = arch["n_layers"]
    tok = torch.as_tensor(np.asarray(tokens, dtype=np.int64) % arch["vocab"], device=device)
    p = group(0)
    h = p["embed.e"][tok]
    h = h + p["pos.e"][torch.arange(tok.shape[1], device=device) % WHISPER_POSITIONS]
    enc = R.stub_rows(batch_rows, (arch["enc_len"], arch["d_model"]), 1, device, dt)
    for i in range(L):
        p = group(1 + i)
        pre = f"layers.{i}"
        h = h + R._self_attention(p, f"{pre}.self_attn", R._norm(p, f"{pre}.ln_self", h), arch)
        h = h + _cross_attention(p, f"{pre}.cross_attn", R._norm(p, f"{pre}.ln_cross", h),
                                 enc, arch)
        h = h + R._mlp(p, f"{pre}.mlp", R._norm(p, f"{pre}.ln_mlp", h), "gelu")
    p = group(L + 1)
    return R._mm(R._norm(p, "ln_f", h), p["lm_head.w"], p)


def forward_flops(arch: dict, batch: int, seq: int) -> float:
    """Each linear layer (the LM head over every position, the K/V
    projections of the encoder's frames), the causal self-attention products
    over the S(S+1)/2 pairs a row attends and the cross-attention products."""
    d, h, f, v = (arch[k] for k in ("d_model", "n_heads", "d_ff", "vocab"))
    hd = d // h
    S = seq
    T = batch * S
    attn = 2 * batch * h * hd * S * (S + 1)  # QK^T and PV over the causal pairs
    F_ = arch["enc_len"]
    per_layer = (
        2 * T * d * 4 * d  # self-attention q, k, v, o
        + attn
        + 2 * T * d * 2 * d  # cross-attention q, o
        + 2 * batch * F_ * d * 2 * d  # cross-attention k, v over the frames
        + 2 * 2 * batch * h * hd * seq * F_  # cross-attention products
        + 2 * T * d * f * 2  # GELU MLP
    )
    return float(arch["n_layers"] * per_layer + 2 * T * d * v)


def flash_calls(arch: dict, batch: int, seq: int) -> list[tuple[int, int, int, int, int]]:
    """(B, S, H, Hkv, D) of each flash launch of one forward: the causal
    self-attention of each layer, at as many K/V heads as query heads."""
    h = arch["n_heads"]
    return [(batch, seq, h, h, arch["d_model"] // h)] * arch["n_layers"]
