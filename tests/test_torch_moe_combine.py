"""The MoE layer's gated combine (``kernels.ops.moe_combine``).

On the CPU: the plain version (``kernels.ref.moe_combine_ref``) against the
scatter-and-sum formula the port used before the kernel, kept here as the
oracle, within float32 rounding (the oracle's sum over experts associates
differently), on dispatch plans from the layer's own router; its gradients
against autograd through the oracle; the CUDA wrapper's plan and its
refusal of CPU tensors.

On the card (marked ``cuda``; they skip without one): the kernel bit for bit
against the plain version on the same CUDA tensors, a second call, a CUDA
graph, the backward, the memory of a granite-moe layer and the wrapper's
checks. Run them there with
``python -m pytest -q -m cuda tests/test_torch_moe_combine.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import nn as tnn  # noqa: E402
from repro_torch.kernels import moe_combine as tmc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

tmoe = importlib.import_module("repro_torch.nn.moe")   # ``nn.moe`` is the function


def oracle(ye, gsel, tok_idx, S):
    """The port's combine before the kernel: the gated outputs scattered into
    a zero-filled [B, E, S, d] buffer, summed over E, in float32 (float64 for
    a float64 ye)."""
    B, E, C, d = ye.shape
    ye = ye * (gsel * (gsel > 0))[..., None].to(ye.dtype)
    dt = torch.promote_types(ye.dtype, torch.float32)
    buf = torch.zeros((B, E, S, d), dtype=dt, device=ye.device)
    buf.scatter_(2, tok_idx[..., None].expand(B, E, C, d), ye.to(dt))
    return buf.sum(dim=1)


PLANS = {
    # a small capacity factor: tokens dropped, experts full
    "dropped": dict(B=2, S=24, E=8, k=2, cf=0.5, d=16),
    # 40 experts padded to 48, granite-moe's top-8: slots left empty, padded
    # experts never routed to
    "padded": dict(B=2, S=16, E=40, k=8, cf=1.25, d=24),
    # a row of one token repeated: tied gates compete for the capacity
    "tied": dict(B=2, S=16, E=4, k=1, cf=1.25, d=8, repeated=True),
    "b1": dict(B=1, S=9, E=6, k=2, cf=1.25, d=10),
    # a decode step: S 1, C 1
    "s1_c1": dict(B=3, S=1, E=40, k=8, cf=1.25, d=16),
    # the sharded path's block of a rank's experts (16 of 48)
    "expert_block": dict(B=2, S=16, E=40, k=8, cf=1.25, d=24, block=(16, 16)),
}


def plan(name, seed=0, device="cpu"):
    """(gsel, tok_idx, S) routed by a MoE layer's own router on random
    tokens, as ``nn.moe._route`` plans them (the expert block's columns for
    ``block``)."""
    c = PLANS[name]
    gen = torch.Generator().manual_seed(seed)
    params = tnn.MoE(c["d"], 8, c["E"], generator=gen)
    if c.get("repeated"):
        x = torch.randn(c["B"], 1, c["d"], generator=gen).expand(c["B"], c["S"], c["d"])
    else:
        x = torch.randn(c["B"], c["S"], c["d"], generator=gen)
    gsel, tok_idx, _, _ = tmoe._route(params, x, top_k=c["k"], capacity_factor=c["cf"],
                                      E_phys=tmoe._phys_experts(c["E"]))
    if "block" in c:
        e0, el = c["block"]
        gsel, tok_idx = gsel[:, e0:e0 + el], tok_idx[:, e0:e0 + el]
    return gsel.contiguous().to(device), tok_idx.to(device), c["S"]


def expert_outputs(gsel, d, dtype, seed=1):
    """ye [B, E, C, d] laid out as the expert FFN's einsum leaves it, E
    outermost."""
    B, E, C = gsel.shape
    gen = torch.Generator().manual_seed(seed)
    ye = torch.randn(E, B, C, d, generator=gen).to(dtype).transpose(0, 1)
    return ye.to(gsel.device)


def f32_close(got, want, terms):
    """Equal up to float32 reassociation: a few ulps of the largest partial
    sum, which is at most the sum of |term|."""
    scale = float(terms.abs().max()) * terms.shape[1]
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=8 * 2.0 ** -24 * max(scale, 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", PLANS)
def test_plain_version_matches_the_scatter_and_sum_oracle(name, dtype):
    gsel, tok_idx, S = plan(name)
    ye = expert_outputs(gsel, PLANS[name]["d"], dtype)
    slot_of = tmoe._slot_of(tok_idx, gsel, S)
    want = oracle(ye, gsel, tok_idx, S)
    got = ops.moe_combine(ye, gsel, slot_of, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    f32_close(got, want, ye.float())
    # in ye's dtype: the f32 sum rounded once
    low = ops.moe_combine(ye, gsel, slot_of)
    assert low.dtype == dtype
    assert torch.equal(low, got.to(dtype))


def test_plans_cover_empty_slots_of_live_tokens_and_drops():
    """The plans hold what the oracle comparison has to cover: empty slots
    whose index points at a token some other expert holds, and dropped
    choices."""
    gsel, tok_idx, S = plan("padded")
    live = torch.zeros(gsel.shape[0], S, dtype=torch.bool)
    for b in range(gsel.shape[0]):
        live[b, tok_idx[b][gsel[b] > 0]] = True
    empty = gsel <= 0
    assert bool(empty.any())
    assert bool(torch.gather(live, 1, tok_idx.flatten(1))[empty.flatten(1)].any())
    assert bool((gsel[:, 40:] <= 0).all())            # padded experts hold nothing
    gsel, *_ = plan("dropped")
    assert int((gsel > 0).sum()) < 2 * 24 * 2         # fewer slots used than choices


@pytest.mark.parametrize("name", PLANS)
def test_slot_of_inverts_the_plan(name):
    gsel, tok_idx, S = plan(name)
    slot_of = tmoe._slot_of(tok_idx, gsel, S)
    assert slot_of.dtype == torch.int32 and slot_of.shape == (*gsel.shape[:2], S)
    used = gsel > 0
    assert int((slot_of >= 0).sum()) == int(used.sum())
    b, e, c = used.nonzero(as_tuple=True)
    assert torch.equal(slot_of[b, e, tok_idx[b, e, c]].long(), c)


def test_float64_ye_sums_in_float64():
    gsel, tok_idx, S = plan("padded")
    ye = expert_outputs(gsel, PLANS["padded"]["d"], torch.float64)
    got = ops.moe_combine(ye, gsel, tmoe._slot_of(tok_idx, gsel, S))
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, oracle(ye, gsel, tok_idx, S), rtol=1e-12, atol=1e-12)


def grads(fn, ye, gsel):
    ye, gsel = ye.detach().requires_grad_(), gsel.detach().requires_grad_()
    y = fn(ye, gsel)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)).to(y)
    return torch.autograd.grad(y, (ye, gsel), dy)


@pytest.mark.parametrize("name", ["dropped", "padded", "s1_c1", "expert_block"])
def test_gradients_equal_autograd_through_the_oracle(name):
    gsel, tok_idx, S = plan(name)
    ye = expert_outputs(gsel, PLANS[name]["d"], torch.float32)
    slot_of = tmoe._slot_of(tok_idx, gsel, S)
    got = grads(lambda y_, g_: ops.moe_combine(y_, g_, slot_of), ye, gsel)
    want = grads(lambda y_, g_: oracle(y_, g_, tok_idx, S), ye, gsel)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["dropped", "padded", "tied", "b1", "s1_c1"])
def test_explicit_backward_equals_the_plain_versions_autograd(name, dtype):
    """``ref.moe_combine_grad``, the CUDA route's backward, against autograd
    through the plain version on the CPU."""
    gsel, tok_idx, S = plan(name)
    ye = expert_outputs(gsel, PLANS[name]["d"], dtype)
    slot_of = tmoe._slot_of(tok_idx, gsel, S)
    want = grads(lambda y_, g_: ref.moe_combine_ref(y_, g_, slot_of,
                                                    out_dtype=torch.float32), ye, gsel)
    dy = torch.randn((ye.shape[0], S, ye.shape[3]), generator=torch.Generator().manual_seed(5))
    got = ref.moe_combine_grad(dy, ye, gsel, slot_of)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w)


def test_moe_layer_matches_the_oracle_combine(monkeypatch):
    """The whole layer, f32 and bf16, against the layer with the oracle's
    combine put back."""
    gen = torch.Generator().manual_seed(2)
    params = tnn.MoE(24, 16, 40, generator=gen)
    x = torch.randn(2, 12, 24, generator=gen)

    def old(x_, gsel, tok_idx, wg, wu, wd, *, out_dtype=None):
        rows = torch.arange(x_.shape[0])[:, None, None]
        ye = tmoe._expert_ffn(x_[rows, tok_idx], wg.to(x_.dtype), wu.to(x_.dtype),
                              wd.to(x_.dtype))
        return oracle(ye, gsel, tok_idx, x_.shape[1]).to(out_dtype or x_.dtype)

    with torch.no_grad():
        got = [tnn.moe(params, x.to(dt), top_k=8)[0] for dt in (torch.float32, torch.bfloat16)]
        monkeypatch.setattr(tmoe, "_dispatch_compute_combine", old)
        want = [tnn.moe(params, x.to(dt), top_k=8)[0] for dt in (torch.float32, torch.bfloat16)]
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert got[1].dtype == torch.bfloat16
    torch.testing.assert_close(got[1], want[1], rtol=2.0 ** -8, atol=2.0 ** -8)


def test_cpu_tensors_take_the_plain_version_without_launch():
    gsel, tok_idx, S = plan("padded")
    ye = expert_outputs(gsel, 24, torch.float32)
    slot_of = tmoe._slot_of(tok_idx, gsel, S)
    before = ops.launch_counts()
    assert torch.equal(ops.moe_combine(ye, gsel, slot_of), ref.moe_combine_ref(ye, gsel, slot_of))
    assert ops.launch_counts() == before


def test_kernel_wrapper_refuses_cpu_tensors():
    gsel, tok_idx, S = plan("b1")
    ye = expert_outputs(gsel, 10, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmc.moe_combine(ye, gsel, tmoe._slot_of(tok_idx, gsel, S))


@pytest.mark.parametrize("B,S,E,sm", [(32, 448, 48, 132), (1, 448, 48, 132), (32, 1, 48, 132),
                                      (1, 1, 1, 132), (4, 100, 128, 132), (2, 37, 1000, 16),
                                      (64, 4096, 48, 132)])
def test_plan_tokens_fills_the_card_within_shared_memory(B, S, E, sm):
    tok = tmc.plan_tokens(B, S, E, sm)
    assert 1 <= tok <= tmc.MAX_TOK and tok & (tok - 1) == 0
    assert tmc.smem_bytes(E, tok) <= tmc.SMEM_LIMIT
    blocks = B * -(-S // tok)
    assert blocks >= 2 * sm or tok == 1 or tmc.smem_bytes(E, 2 * tok) > tmc.SMEM_LIMIT
    if tok < tmc.MAX_TOK and tmc.smem_bytes(E, 2 * tok) <= tmc.SMEM_LIMIT:
        assert B * -(-S // (2 * tok)) < 2 * sm       # no larger tile fills the card


def test_plan_tokens_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        tmc.plan_tokens(1, 1, 4000, 132)
    with pytest.raises(ValueError, match=">= 1"):
        tmc.plan_tokens(0, 1, 4, 132)


# ------------------------------------------------------------- on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel builds and runs only there")
    return torch.device("cuda")


SERVE3 = dict(B=32, S=448, E=40, k=8, d=1536)   # granite-moe at the cells' batches


def granite_plan(device, B=32, S=448, seed=0):
    """gsel, tok_idx, slot_of of one granite-moe layer (E 40 padded to 48, C
    112) on random tokens."""
    gen = torch.Generator().manual_seed(seed)
    params = tnn.MoE(SERVE3["d"], 512, SERVE3["E"], generator=gen).to(device)
    x = torch.randn(B, S, SERVE3["d"], generator=gen).to(device)
    gsel, tok_idx, _, _ = tmoe._route(params, x, top_k=8, capacity_factor=1.25, E_phys=48)
    return gsel.contiguous(), tok_idx, tmoe._slot_of(tok_idx, gsel, S)


def on_card(gsel, d, dtype, seed=1):
    B, E, C = gsel.shape
    gen = torch.Generator(device=gsel.device).manual_seed(seed)
    return torch.randn((E, B, C, d), generator=gen, device=gsel.device).to(dtype).transpose(0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "ye"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain_version_bit_for_bit_at_serve3(cuda, dtype, out):
    gsel, _, slot_of = granite_plan(cuda)
    ye = on_card(gsel, SERVE3["d"], dtype)
    out_dtype = torch.float32 if out == "float32" else dtype
    before = ops.launch_counts()["moe_combine"]
    got = ops.moe_combine(ye, gsel, slot_of, out_dtype=out_dtype)
    again = ops.moe_combine(ye, gsel, slot_of, out_dtype=out_dtype)
    want = ref.moe_combine_ref(ye, gsel, slot_of, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_combine"] == before + 2
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(got, again)                    # the same bits on every call


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,layout", [(100, "ffn"), (1536, "contiguous"), (20, "offset")])
def test_kernel_equals_plain_version_on_ragged_shapes(cuda, dtype, d, layout):
    """An odd S, a d that the 16-byte vector does not divide, a contiguous ye
    and one whose rows start off 16 bytes (the scalar loads)."""
    gen = torch.Generator().manual_seed(3)
    params = tnn.MoE(d, 16, 40, generator=gen).to(cuda)
    x = torch.randn(3, 37, d, generator=gen).to(cuda)
    gsel, tok_idx, _, _ = tmoe._route(params, x, top_k=8, capacity_factor=1.25, E_phys=48)
    gsel, slot_of = gsel.contiguous(), tmoe._slot_of(tok_idx, gsel, 37)
    ye = on_card(gsel, d + 1, dtype)
    ye = {"ffn": ye[..., :d], "contiguous": ye[..., :d].contiguous(),
          "offset": ye[..., 1:]}[layout]
    for out_dtype in (torch.float32, dtype):
        got = ops.moe_combine(ye, gsel, slot_of, out_dtype=out_dtype)
        assert torch.equal(got, ref.moe_combine_ref(ye, gsel, slot_of, out_dtype=out_dtype))


@pytest.mark.cuda
def test_kernel_equals_plain_version_at_a_decode_step(cuda):
    gsel, _, slot_of = granite_plan(cuda, B=32, S=1)
    ye = on_card(gsel, SERVE3["d"], torch.bfloat16)
    assert gsel.shape[2] == 1
    assert torch.equal(ops.moe_combine(ye, gsel, slot_of),
                       ref.moe_combine_ref(ye, gsel, slot_of))


@pytest.mark.cuda
def test_kernel_runs_inside_a_cuda_graph(cuda):
    gsel, _, slot_of = granite_plan(cuda, B=4, S=64)
    ye = on_card(gsel, SERVE3["d"], torch.bfloat16)
    want = ops.moe_combine(ye, gsel, slot_of)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.moe_combine(ye, gsel, slot_of)             # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.moe_combine(ye, gsel, slot_of)
    ye.mul_(2.0)                                       # exact in bf16: every term doubles
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.moe_combine(ye, gsel, slot_of))
    assert torch.equal(out.float(), 2.0 * want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_backward_equals_the_plain_versions_autograd(cuda, dtype):
    gsel, _, slot_of = granite_plan(cuda, B=4, S=64)
    ye = on_card(gsel, SERVE3["d"], dtype).contiguous()
    dy = torch.randn((4, 64, SERVE3["d"]), device=cuda)

    def grad(fn):
        y_, g_ = ye.detach().requires_grad_(), gsel.detach().requires_grad_()
        return torch.autograd.grad(fn(y_, g_, slot_of, out_dtype=torch.float32), (y_, g_), dy)

    before = ops.launch_counts()["moe_combine"]
    got = grad(ops.moe_combine)
    assert ops.launch_counts()["moe_combine"] == before + 1
    for g, w in zip(got, grad(ref.moe_combine_ref), strict=True):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w)


@pytest.mark.cuda
def test_moe_layer_memory_at_granite_moe_b32(cuda):
    """One granite-moe layer at B 32 x 448 in bf16 holds less than 1.5 GiB
    beyond its inputs (the [B, E, S, d] f32 buffer alone was 3.94 GiB)."""
    gen = torch.Generator().manual_seed(4)
    params = tnn.MoE(SERVE3["d"], 512, SERVE3["E"], generator=gen).to(cuda)
    for w in (params.experts.wg, params.experts.wu, params.experts.wd):
        w.data = w.data.to(torch.bfloat16)
    x = torch.randn(32, 448, SERVE3["d"], generator=gen).to(cuda, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        y, _ = tnn.moe(params, x, top_k=8, need_aux=False)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    assert torch.cuda.max_memory_allocated() - base < 1.5 * 2**30


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_does_not_take(cuda):
    gsel, _, slot_of = granite_plan(cuda, B=2, S=16)
    ye = on_card(gsel, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmc.moe_combine(ye, gsel.cpu(), slot_of)
    with pytest.raises(ValueError, match="ye is"):
        tmc.moe_combine(ye.half(), gsel, slot_of)
    with pytest.raises(ValueError, match="int32"):
        tmc.moe_combine(ye, gsel, slot_of.long())
    with pytest.raises(ValueError, match="out_dtype"):
        tmc.moe_combine(ye, gsel, slot_of, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="do not match"):
        tmc.moe_combine(ye, gsel[:, :-1].contiguous(), slot_of)
    with pytest.raises(ValueError, match="contiguous"):
        tmc.moe_combine(ye.transpose(2, 3).contiguous().transpose(2, 3), gsel, slot_of)
    with pytest.raises(ValueError, match="contiguous"):
        tmc.moe_combine(ye, gsel.transpose(1, 2).contiguous().transpose(1, 2), slot_of)
    assert np.isfinite(tmc.moe_combine(ye, gsel, slot_of).float().cpu().numpy()).all()
