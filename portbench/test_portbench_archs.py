"""The per-architecture parts of the yardstick, held to the bit against what
they read before they moved into reference modules (``portbench/archs/``):
for every architecture of both configurations that a reference covers, its
parameter layout at published and smoke size, a digest of every weight group
at two seeds, the reference logits of three rows in f32 and in the fp8
control, and the operation and flash-launch counts of two batches. The
values were recorded on the CPU at smoke size (``smoke.reduce_arch``, the
configurations' bf16) from the code before the move; a digest is the first
16 hex digits of the SHA-256 of the bytes."""

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import counts, reference, smoke, spec, weights

BENCH = spec.load_benchmark()
ARCHS = {**spec.load_config(BENCH, "serve3-bf16")["archs"],
         **spec.load_config(BENCH, "edge4-bf16")["archs"]}
STAGE, VARIANT = 2, 1  # the weights' group keys
ROWS = [(4, 3), (4, 0), (2, 1)]  # (batch size, row) of the three reference rows
LOGIT_SEED = 2**31 + 5

EXPECTED = {
    "whisper-small": {
        "layout": {"full": ("cb919335abeffe4d", 293), "smoke": ("ad11fe9c9a92dcf1", 53)},
        "weights": {
            7: ["9a06ec9d7eb8da3e", "0b00e7564fb81b81", "a902f19818b004c7", "b9827247c02290e8"],
            2147483653: ["6251ee5a34089be3", "caddce1c99aba1df", "374bcbc7f6efa5cb", "4c127f4a8d867a19"],
        },
        "logits": {
            None: ("458a6b31245714c4", (3, 16, 512)),
            "fp8": ("d0cdfe082d2482aa", (3, 16, 512)),
        },
        "counts": {
            (3, 16): (143407816704, (3, 16, 12, 12, 64), 12),
            (32, 448): (6253515374592, (32, 448, 12, 12, 64), 12),
        },
    },
    "starcoder2-3b": {
        "layout": {"full": ("b75b79b1e1fcc4fc", 454), "smoke": ("60a87bdf19d8b3e5", 34)},
        "weights": {
            7: ["a9447b8ecba18fd6", "81a55e59c02211b2", "e96ee142dcd10d7a", "b9827247c02290e8"],
            2147483653: ["746feb5f3620cf17", "6735e1add091968a", "c26e098c25fe621b", "4c127f4a8d867a19"],
        },
        "logits": {
            None: ("c0d81039c97c8cdf", (3, 16, 512)),
            "fp8": ("6cc90b7de78791b2", (3, 16, 512)),
        },
        "counts": {
            (3, 16): (290966667264, (3, 16, 24, 2, 128), 30),
            (32, 448): (88043566399488, (32, 448, 24, 2, 128), 30),
        },
    },
    "granite-moe-3b-a800m": {
        "layout": {"full": ("1aa554b8292d32c5", 323), "smoke": ("580adc787830a39b", 23)},
        "weights": {
            7: ["a9447b8ecba18fd6", "b28aa515393be995", "58ed41551e67706e", "0238729cde42485b"],
            2147483653: ["746feb5f3620cf17", "57a36a49ca2aea93", "2cfd993848ff7dde", "da8d33c98b480094"],
        },
        "logits": {
            None: ("55d8e129b89ea61a", (3, 16, 512)),
            "fp8": ("ed8a137630207449", (3, 16, 512)),
        },
        "counts": {
            (3, 16): (84826570752, (3, 16, 24, 8, 64), 32),
            (32, 448): (25943680745472, (32, 448, 24, 8, 64), 32),
        },
    },
    "granite-3-8b": {
        "layout": {"full": ("133b51b58e705307", 363), "smoke": ("665b86828cafec6d", 21)},
        "weights": {
            7: ["a9447b8ecba18fd6", "56bfab9983c38e38", "4341a596573fa9b4", "0238729cde42485b"],
            2147483653: ["746feb5f3620cf17", "540a3369e2dd7f11", "06f6e1ac8ffc5d99", "da8d33c98b480094"],
        },
        "logits": {
            None: ("5e04e3ca2e4b55cc", (3, 16, 512)),
            "fp8": ("faedbd497f185878", (3, 16, 512)),
        },
        "counts": {
            (3, 16): (784636968960, (3, 16, 32, 8, 128), 40),
            (32, 448): (236374280110080, (32, 448, 32, 8, 128), 40),
        },
    },
    "llava-next-mistral-7b": {
        "layout": {"full": ("71262cfd93e7acd4", 292), "smoke": ("5b55804165c06539", 22)},
        "weights": {
            7: ["8a8951acf26c8620", "56bfab9983c38e38", "4341a596573fa9b4", "0238729cde42485b"],
            2147483653: ["ccd14da957e90c7c", "540a3369e2dd7f11", "06f6e1ac8ffc5d99", "da8d33c98b480094"],
        },
        "logits": {
            None: ("1f59a8b1e701ef40", (3, 24, 512)),
            "fp8": ("c063b6a7f05a8a7b", (3, 24, 512)),
        },
        "counts": {
            (3, 16): (25590182707200, (3, 592, 32, 8, 128), 32),
            (32, 448): (475409929994240, (32, 1024, 32, 8, 128), 32),
        },
    },
}
UNCOVERED = ["xlstm-125m", "zamba2-2.7b"]


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().flatten().view(torch.uint8).numpy().tobytes()


def layout_digest(params) -> tuple[str, int]:
    return digest(json.dumps([[n, list(s), str(dt)] for n, s, dt in params]).encode()), len(params)


def test_every_architecture_is_held():
    assert set(EXPECTED) | set(UNCOVERED) == set(ARCHS)
    assert set(EXPECTED).isdisjoint(UNCOVERED)
    assert all(weights.supported(ARCHS[n]) for n in EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_layout_is_unmoved(name):
    full = ARCHS[name]
    small = smoke.reduce_arch(full)
    assert layout_digest(weights.layout(full)) == EXPECTED[name]["layout"]["full"]
    assert layout_digest(weights.layout(small)) == EXPECTED[name]["layout"]["smoke"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_weight_groups_are_unmoved(name):
    small = smoke.reduce_arch(ARCHS[name])
    params = weights.layout(small)
    for seed, want in EXPECTED[name]["weights"].items():
        got = [digest(b"".join(tensor_bytes(t) for t in weights.group(
                   small, seed, STAGE, VARIANT, i, "cpu", params).values()))
               for i in range(small["n_layers"] + 2)]
        assert got == want, seed


@pytest.mark.parametrize("quant", [None, "fp8"])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reference_logits_are_unmoved(name, quant):
    small = smoke.reduce_arch(ARCHS[name])
    tokens = np.random.default_rng(0).integers(1, 512, size=(3, 16)).astype(np.int32)
    with torch.no_grad():
        got = reference.logits(small, LOGIT_SEED, 1, 0, tokens, ROWS, "cpu", quant=quant)
    assert (digest(tensor_bytes(got)), tuple(got.shape)) == EXPECTED[name]["logits"][quant]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_counts_are_unmoved(name):
    for (B, S), (flops, call, n) in EXPECTED[name]["counts"].items():
        assert counts.forward_flops(ARCHS[name], B, S) == float(flops)
        assert counts.flash_calls(ARCHS[name], B, S) == [call] * n


@pytest.mark.parametrize("name", UNCOVERED)
def test_uncovered_architectures_have_no_reference(name):
    """The recurrent families have no reference module: the program keeps its
    own weights, the harness counts them unchecked, and no count is made.
    (Before the move ``flash_calls`` gave them one launch a layer, which their
    forwards do not make; now it raises, and ``flash_roofline`` reads none.)"""
    arch = ARCHS[name]
    assert not weights.supported(arch) and spec.reference_module(arch) is None
    for count in (counts.forward_flops, counts.flash_calls):
        with pytest.raises(ValueError):
            count(arch, 3, 16)
    with pytest.raises(ValueError):
        weights.layout(arch)
