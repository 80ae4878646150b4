"""Operations and bytes of the cells' work, from the shapes of the batches that
ran (frozen here, so the yardstick does not move with the program).

``forward_flops`` counts every matrix product of one stage forward over a
batch: each linear layer (the LM head over every position, whisper's K/V
projections of its 1,500 encoder frames), the causal attention products over
the S(S+1)/2 pairs a row attends, whisper's cross-attention products, and in a
MoE layer the router and the top-k experts each token is routed to. Norms,
softmax and element-wise work are not counted.

``flash_flops``/``flash_bytes`` are one flash-attention launch's: the causal
products, and each input byte read once and each output byte written once.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def positions(arch: dict, seq: int) -> int:
    """Positions of one row: the vlm's patches come before its tokens."""
    return seq + (arch["n_patches"] if arch["family"] == "vlm" else 0)


def forward_flops(arch: dict, batch: int, seq: int) -> float:
    fam = arch["family"]
    if fam not in ("dense", "moe", "vlm", "audio"):
        raise ValueError(f"no operation count for the {fam} family")
    d, h, kv, f, v = (arch[k] for k in ("d_model", "n_heads", "n_kv", "d_ff", "vocab"))
    hd = d // h
    S = positions(arch, seq)
    T = batch * S
    attn = 2 * batch * h * hd * S * (S + 1)  # QK^T and PV over the causal pairs
    if fam == "audio":
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
    proj = 2 * T * d * (h * hd + 2 * kv * hd) + 2 * T * h * hd * d
    if arch["n_experts"]:
        mlp = 2 * T * d * arch["n_experts"] + arch["top_k"] * 3 * 2 * T * d * f
    else:
        mlp = (3 if arch["mlp_kind"] == "swiglu" else 2) * 2 * T * d * f
    total = arch["n_layers"] * (proj + attn + mlp) + 2 * T * d * v
    if fam == "vlm":
        total += 2 * batch * arch["n_patches"] * d * d
    return float(total)


def flash_calls(arch: dict, batch: int, seq: int) -> list[tuple[int, int, int, int, int]]:
    """(B, S, H, Hkv, D) of each flash launch of one forward."""
    h = arch["n_heads"]
    kv = h if arch["family"] == "audio" else arch["n_kv"]
    return [(batch, positions(arch, seq), h, kv, arch["d_model"] // h)] * arch["n_layers"]


def flash_flops(B: int, S: int, H: int, Hkv: int, D: int) -> float:
    return float(2 * B * H * D * S * (S + 1))


def flash_bytes(B: int, S: int, H: int, Hkv: int, D: int, dtype: str = "bfloat16") -> float:
    return float(DTYPE_BYTES[dtype] * B * S * D * (2 * H + 2 * Hkv))


def flash_bound_s(call, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: max(ops / peak, bytes / bandwidth)."""
    return max(flash_flops(*call) / PEAK_FLOPS[dtype], flash_bytes(*call, dtype) / PEAK_BYTES)
