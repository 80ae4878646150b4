"""The plain reference against the port's forward at smoke sizes, in float32
on the CPU, with the benchmark's weights copied into the port's parameters
(``weights.fill``, which also holds the port's parameter layout)."""

import numpy as np
import pytest
import torch

from portbench import reference, smoke, spec, weights

BENCH = spec.load_benchmark()
ARCHS = spec.load_config(BENCH, "edge4-bf16")["archs"]
HELD = [n for n, a in ARCHS.items() if weights.supported(a)]


def small(name):
    return {**smoke.reduce_arch(ARCHS[name]), "dtype": "float32"}


@pytest.mark.parametrize("name", HELD)
def test_reference_matches_the_port(name):
    from repro_torch.models import api
    from repro_torch.models.config import ArchConfig
    from repro_torch.serving.engine import StageServer

    arch = small(name)
    cfg = ArchConfig(**arch)
    server = StageServer("s", [cfg], seq_len=12, seed=0, device="cpu")
    weights.fill(server.params[0], arch, 2**31 + 5, 1, 0)
    tokens = np.random.default_rng(0).integers(1, 256, size=(3, 12)).astype(np.int32)
    with torch.no_grad():
        port, _ = api.forward(server.params[0], server._make_batch(tokens, cfg), cfg)
        ref = reference.logits(arch, 2**31 + 5, 1, 0, tokens[[2, 0]], [(3, 2), (3, 0)], "cpu")
    assert ref.shape == port[[2, 0]].shape
    err = (ref - port[[2, 0]]).abs().max().item()
    assert err < 1e-4 * max(1.0, port.abs().max().item()), err
    assert reference.gaps(ref, port[[2, 0]].argmax(-1).numpy()).max().item() == 0.0


def test_other_seed_other_weights_same_seed_same_weights():
    arch = small("granite-3-8b")
    params = weights.layout(arch)
    a = weights.group(arch, 7, 3, 0, 1, "cpu", params)
    b = weights.group(arch, 7, 3, 0, 1, "cpu", params)
    c = weights.group(arch, 8, 3, 0, 1, "cpu", params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attn.wq.w"], c["layers.0.attn.wq.w"])
    w = a["layers.0.mlp.wg.w"]
    assert abs(w.std().item() - w.shape[0] ** -0.5) < 0.1 * w.shape[0] ** -0.5


def test_fill_refuses_another_layout():
    from repro_torch.models import api
    from repro_torch.models.config import ArchConfig

    arch = small("starcoder2-3b")
    model = api.init_model(0, ArchConfig(**{**arch, "norm": "rmsnorm"}), device="cpu")
    with pytest.raises(RuntimeError, match="layout"):
        weights.fill(model, arch, 1, 0, 0)


def test_gaps_of_served_tokens():
    ref = torch.tensor([[[0.0, 2.0, 1.0], [3.0, 0.5, 0.0]]])
    assert reference.gaps(ref, np.array([[1, 0]])).tolist() == [[0.0, 0.0]]
    assert reference.gaps(ref, np.array([[2, 1]])).tolist() == [[1.0, 2.5]]
    assert reference.gaps(ref, np.array([[7, 1]])).isinf().all()
