"""The frozen operation and byte counts against counts by hand, one batch of
each architecture the cells run (B = 2 rows of S = 448 tokens)."""

import pytest

from portbench import counts, spec

BENCH = spec.load_benchmark()
ARCHS = {**spec.load_config(BENCH, "edge4-bf16")["archs"]}
B, S = 2, 448
T = B * S


def dense_by_hand(L, d, H, kv, f, V, mats):
    hd = d // H
    per_layer = (
        2 * T * d * H * hd          # q
        + 2 * 2 * T * d * kv * hd   # k, v
        + 2 * T * H * hd * d        # o
        + 2 * B * H * hd * S * (S + 1)  # QK^T and PV over S(S+1)/2 pairs, 2 flops a MAC
        + mats * 2 * T * d * f      # MLP
    )
    return L * per_layer + 2 * T * d * V


def test_granite_3_8b():
    want = dense_by_hand(40, 4096, 32, 8, 12800, 49155, 3)
    assert counts.forward_flops(ARCHS["granite-3-8b"], B, S) == want
    # about 2 x 8.2e9 parameters x 896 positions, plus attention
    assert 1.45e13 < want < 1.6e13


def test_starcoder2_3b():
    want = dense_by_hand(30, 3072, 24, 2, 12288, 49152, 2)
    assert counts.forward_flops(ARCHS["starcoder2-3b"], B, S) == want


def test_granite_moe_counts_only_routed_experts():
    L, d, H, kv, f, V, E, k = 32, 1536, 24, 8, 512, 49155, 40, 8
    hd = d // H
    per_layer = (2 * T * d * (H * hd + 2 * kv * hd) + 2 * T * H * hd * d
                 + 2 * B * H * hd * S * (S + 1)
                 + 2 * T * d * E            # router
                 + k * 3 * 2 * T * d * f)   # 8 of 40 experts a token, SwiGLU
    want = L * per_layer + 2 * T * d * V
    assert counts.forward_flops(ARCHS["granite-moe-3b-a800m"], B, S) == want


def test_whisper_small_counts_cross_attention_over_frames():
    L, d, H, f, V, Fr = 12, 768, 12, 3072, 51865, 1500
    hd = d // H
    per_layer = (4 * 2 * T * d * d              # self q, k, v, o
                 + 2 * B * H * hd * S * (S + 1)  # causal self products
                 + 2 * 2 * T * d * d            # cross q, o
                 + 2 * 2 * B * Fr * d * d       # cross k, v over 1500 frames
                 + 2 * 2 * B * H * hd * S * Fr  # cross products
                 + 2 * 2 * T * d * f)           # GELU MLP
    want = L * per_layer + 2 * T * d * V
    assert counts.forward_flops(ARCHS["whisper-small"], B, S) == want


def test_llava_counts_its_patches():
    a = ARCHS["llava-next-mistral-7b"]
    P = 576
    Sp = S + P
    hd = 4096 // 32
    per_layer = (2 * B * Sp * 4096 * (32 * hd + 2 * 8 * hd) + 2 * B * Sp * 32 * hd * 4096
                 + 2 * B * 32 * hd * Sp * (Sp + 1) + 3 * 2 * B * Sp * 4096 * 14336)
    want = 32 * per_layer + 2 * B * Sp * 4096 * 32000 + 2 * B * P * 4096 * 4096
    assert counts.forward_flops(a, B, S) == want


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b"])
def test_recurrent_families_are_not_counted(name):
    with pytest.raises(ValueError):
        counts.forward_flops(ARCHS[name], B, S)


def test_flash_launch_counts():
    calls = counts.flash_calls(ARCHS["granite-3-8b"], B, S)
    assert calls == [(B, S, 32, 8, 128)] * 40
    assert counts.flash_calls(ARCHS["whisper-small"], 4, S) == [(4, S, 12, 12, 64)] * 12
    c = (B, S, 32, 8, 128)
    assert counts.flash_flops(*c) == 2 * 2 * B * 32 * 128 * S * (S + 1) / 2
    # q and out at 32 heads, k and v at 8, two bytes each, read or written once
    assert counts.flash_bytes(*c) == 2 * B * S * 128 * (32 + 32 + 8 + 8)
    bound = counts.flash_bound_s(c)
    assert bound == max(counts.flash_flops(*c) / 989e12, counts.flash_bytes(*c) / 3.35e12)
    # 3.3 GFLOP against 18.4 MB: the bytes bound it at S = 448, the products at 2,048
    assert bound == counts.flash_bytes(*c) / 3.35e12
    long = (1, 2048, 32, 8, 128)
    assert counts.flash_bound_s(long) == counts.flash_flops(*long) / 989e12


def test_trace_union_and_idle_gaps():
    from portbench import trace

    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (95, 130, "c")]
    ann = [(25, 50, "execute whisper-small")]
    assert trace.union(dev, 0, 100) == [[0, 20], [30, 40], [95, 100]]
    assert trace.busy_ns(dev, 0, 100) == 35  # overlaps counted once, clipped to the slice
    gaps = dict(trace.idle_gaps(dev, ann, 0, 100))
    assert gaps == {"execute whisper-small": 10e-9, "runtime (outside execute)": 55e-9}
    assert trace.top_ops(dev)[0] == ["c", 35e-9]
