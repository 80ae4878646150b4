"""Plain reference of the pre-norm decoders: the dense, moe and vlm families.

RMSNorm or LayerNorm, half-split RoPE, grouped-query causal attention, a SwiGLU
or tanh-GELU MLP or a top-k MoE in every layer (``reference._moe``), an untied
head; the vlm prepends its projected patch embeddings. Its layout, forward
and counts follow ``src/repro_torch/models/decoder.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as R, weights as W


def layout(arch: dict) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of every parameter, in the port's order."""
    dt = W.DTYPES[arch["dtype"]]
    d, h, kv, f, v = (arch[k] for k in ("d_model", "n_heads", "n_kv", "d_ff", "vocab"))
    hd = d // h
    out = [("embed.e", (v, d), dt)]
    ln = arch["norm"] == "layernorm"
    for i in range(arch["n_layers"]):
        p = f"layers.{i}"
        out += W._norm(f"{p}.ln_attn", d, ln, dt)
        out += W._attention(f"{p}.attn", d, h, kv, hd, ln, dt)
        out += W._norm(f"{p}.ln_mlp", d, ln, dt)
        if arch["n_experts"]:
            e = W.phys_experts(arch["n_experts"])
            out += [
                (f"{p}.moe.experts.wg", (e, d, f), dt),
                (f"{p}.moe.experts.wu", (e, d, f), dt),
                (f"{p}.moe.experts.wd", (e, f, d), dt),
                (f"{p}.moe.router.w", (d, arch["n_experts"]), torch.float32),
            ]
        else:
            out += W._mlp(f"{p}.mlp", d, f, arch["mlp_kind"], dt)
    out += W._norm("ln_f", d, ln, dt) + [("lm_head.w", (d, v), dt)]
    if arch["family"] == "vlm":
        out.append(("vis_proj.w", (d, d), dt))
    return out


def logits(arch: dict, seed: int, stage: int, variant: int, tokens: np.ndarray,
           batch_rows: list[tuple[int, int]], device, quant: str | None = None):
    """Reference logits [k, S_total, vocab] (f32); ``reference.logits`` says more."""
    dt = W.DTYPES[arch["dtype"]]
    params = layout(arch)

    def group(i):
        return R._weights(arch, seed, stage, variant, i, device, quant, params)

    L = arch["n_layers"]
    tok = torch.as_tensor(np.asarray(tokens, dtype=np.int64) % arch["vocab"], device=device)
    p = group(0)
    h = p["embed.e"][tok]
    if arch["family"] == "vlm":
        patches = R.stub_rows(batch_rows, (arch["n_patches"], arch["d_model"]), 0, device, dt)
        vis = R._mm(patches, p["vis_proj.w"], p)
        h = torch.cat([vis, h], dim=1)
    for i in range(L):
        p = group(1 + i)
        pre = f"layers.{i}"
        h = h + R._self_attention(p, f"{pre}.attn", R._norm(p, f"{pre}.ln_attn", h), arch)
        x = R._norm(p, f"{pre}.ln_mlp", h)
        h = h + (R._moe(p, f"{pre}.moe", x, arch) if arch["n_experts"]
                 else R._mlp(p, f"{pre}.mlp", x, arch["mlp_kind"]))
    p = group(L + 1)
    return R._mm(R._norm(p, "ln_f", h), p["lm_head.w"], p)


def positions(arch: dict, seq: int) -> int:
    """Positions of one row: the vlm's patches come before its tokens."""
    return seq + (arch["n_patches"] if arch["family"] == "vlm" else 0)


def forward_flops(arch: dict, batch: int, seq: int) -> float:
    """Each linear layer (the LM head over every position), the causal
    attention products over the S(S+1)/2 pairs a row attends, and in a MoE
    layer the router and the top-k experts each token is routed to."""
    d, h, kv, f, v = (arch[k] for k in ("d_model", "n_heads", "n_kv", "d_ff", "vocab"))
    hd = d // h
    S = positions(arch, seq)
    T = batch * S
    attn = 2 * batch * h * hd * S * (S + 1)  # QK^T and PV over the causal pairs
    proj = 2 * T * d * (h * hd + 2 * kv * hd) + 2 * T * h * hd * d
    if arch["n_experts"]:
        mlp = 2 * T * d * arch["n_experts"] + arch["top_k"] * 3 * 2 * T * d * f
    else:
        mlp = (3 if arch["mlp_kind"] == "swiglu" else 2) * 2 * T * d * f
    total = arch["n_layers"] * (proj + attn + mlp) + 2 * T * d * v
    if arch["family"] == "vlm":
        total += 2 * batch * arch["n_patches"] * d * d
    return float(total)


def flash_calls(arch: dict, batch: int, seq: int) -> list[tuple[int, int, int, int, int]]:
    """(B, S, H, Hkv, D) of each flash launch of one forward: one a layer."""
    h = arch["n_heads"]
    return [(batch, positions(arch, seq), h, arch["n_kv"], arch["d_model"] // h)] * arch["n_layers"]
