"""Operations and bytes of the cells' work, from the shapes of the batches that
ran (frozen here, so the yardstick does not move with the program).

``forward_flops`` counts every matrix product of one stage forward over a
batch, and ``flash_calls`` lists its flash-attention launches; each
architecture's reference module (``portbench/archs/<module>.py``) holds its
own count. Norms, softmax and element-wise work are not counted.

``flash_flops``/``flash_bytes`` are one flash-attention launch's: the causal
products, and each input byte read once and each output byte written once.
"""

from __future__ import annotations

from pathlib import Path

from portbench import spec

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def forward_flops(arch: dict, batch: int, seq: int, config: dict | None = None,
                  root: Path = spec.ROOT) -> float:
    """The matrix products of one stage forward over ``batch`` rows of ``seq``
    tokens, as the architecture's reference module counts them; raises
    where no module covers it."""
    return spec.reference_for(arch, config, root).forward_flops(arch, batch, seq)


def flash_calls(arch: dict, batch: int, seq: int, config: dict | None = None,
                root: Path = spec.ROOT) -> list[tuple[int, int, int, int, int]]:
    """(B, S, H, Hkv, D) of each flash launch of one forward; raises where no
    reference module covers the architecture."""
    return spec.reference_for(arch, config, root).flash_calls(arch, batch, seq)


def flash_flops(B: int, S: int, H: int, Hkv: int, D: int) -> float:
    return float(2 * B * H * D * S * (S + 1))


def flash_bytes(B: int, S: int, H: int, Hkv: int, D: int, dtype: str = "bfloat16") -> float:
    return float(DTYPE_BYTES[dtype] * B * S * D * (2 * H + 2 * Hkv))


def flash_bound_s(call, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: max(ops / peak, bytes / bandwidth)."""
    return max(flash_flops(*call) / PEAK_FLOPS[dtype], flash_bytes(*call, dtype) / PEAK_BYTES)
