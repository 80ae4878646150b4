"""A Mamba2 layer in the yardstick: the weights made for a state-space
layer's parameters (``weights._init``'s rules keyed on the port's names),
and the plain mixer (``reference._mamba2``, a sequential recurrence) against
the port's chunked ``nn.mamba2.mamba2_scan``, at a small size in float32 on
the CPU. The layout below is this test's own, written from the port's
parameter names; it is held to the port's module."""

import math

import pytest
import torch
import torch.nn.functional as F

from portbench import reference, weights

D, HEADS, STATE, EXPAND, S, CHUNK = 32, 4, 8, 2, 24, 8
ARCH = {"name": "mamba2-layer", "n_layers": 1}  # one layer: group 1 holds it
SEED = 2**31 + 77


def layout(prefix="layers.0.mamba", d=D, heads=HEADS, d_state=STATE, groups=1):
    """The port's ``Mamba2`` parameters, in its order (the module's own, then
    its projections' and norm's), at float32."""
    d_inner, f32 = EXPAND * d, torch.float32
    conv = d_inner + 2 * groups * d_state
    return [(f"{prefix}.{n}", shape, f32) for n, shape in (
        ("conv_w", (4, conv)), ("conv_b", (conv,)), ("a_log", (heads,)),
        ("dt_bias", (heads,)), ("d_skip", (heads,)),
        ("in_z.w", (d, d_inner)), ("in_x.w", (d, d_inner)),
        ("in_bc.w", (d, 2 * groups * d_state)), ("in_dt.w", (d, heads)),
        ("norm.g", (d_inner,)), ("out_proj.w", (d_inner, d)))]


def make(seed=SEED, **kw):
    return weights.group(ARCH, seed, 1, 0, 1, "cpu", layout(**kw))


def port_layer():
    """A port ``Mamba2`` under ``layers.0.mamba``, filled with the benchmark's
    weights through ``weights.group``."""
    from repro_torch.nn.mamba2 import Mamba2

    model = torch.nn.Module()
    model.layers = torch.nn.ModuleList([torch.nn.Module()])
    model.layers[0].mamba = Mamba2(D, expand=EXPAND, n_heads=HEADS, d_state=STATE)
    params = dict(model.named_parameters())
    assert [(n, tuple(p.shape), p.dtype) for n, p in params.items()] == layout()
    with torch.no_grad():
        for name, value in make().items():
            params[name].copy_(value)
    return model.layers[0].mamba


def mixer(p, x, **kw):
    p = {k.removeprefix("layers.0."): v for k, v in p.items()}
    return reference._mamba2({**p, "fp8": False}, "mamba", x, heads=HEADS, d_state=STATE,
                             eps=1e-6, **kw)


def test_state_space_weights_lie_in_their_published_ranges():
    p = make(heads=4096)
    a = -torch.exp(p["layers.0.mamba.a_log"])
    dt = F.softplus(p["layers.0.mamba.dt_bias"].double())
    skip = p["layers.0.mamba.d_skip"]
    assert a.min() >= -16 and a.max() <= -1 and a.min() < -15 and a.max() > -1.05
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)
    assert dt.min() < 1.2e-3 and dt.max() > 0.09
    # log-uniform: half the heads below the geometric midpoint 1e-2
    assert abs((dt < 1e-2).double().mean().item() - 0.5) < 0.05
    assert abs(skip.mean().item() - 1) < 0.01 and abs(skip.std().item() - 0.1) < 0.01
    assert abs(p["layers.0.mamba.conv_b"].std().item() - 0.02) < 0.002
    w = p["layers.0.mamba.conv_w"]
    assert abs(w.std().item() - 0.5) < 0.05  # K^-1/2, the port's own std


def test_same_seed_same_bits_other_seed_other_weights():
    a, b, c = make(), make(), make(SEED + 1)
    assert list(a) == [n for n, _, _ in layout()]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("name", ["layers.0.mamba.a_bias", "layers.0.scale"])
def test_a_parameter_no_rule_names_is_refused(name):
    params = layout() + [(name, (HEADS,), torch.float32)]
    with pytest.raises(ValueError, match=name):
        weights.group(ARCH, SEED, 1, 0, 1, "cpu", params)


def _inputs():
    gen = torch.Generator().manual_seed(3)
    return torch.randn(2, S, D, generator=gen)


def test_mixer_matches_the_ports_chunked_scan():
    from repro_torch.nn.mamba2 import mamba2_scan

    x = _inputs()
    with torch.no_grad():
        port = mamba2_scan(port_layer(), x, n_heads=HEADS, d_state=STATE, expand=EXPAND,
                           chunk=CHUNK)
        ref = mixer(make(), x, gate_first=False)
    bound = 1e-4 * max(1.0, port.abs().max().item())
    assert (ref - port).abs().max().item() < bound
    # published Mamba2 normalises y * SiLU(z): far from the port's norm-first form
    gated = mixer(make(), x)
    assert (gated - port).abs().max().item() > 100 * bound


def test_two_groups_with_equal_b_and_c_give_one_groups_recurrence(monkeypatch):
    """Groups only share B and C among their heads: with both groups' B and C
    (their projections and conv channels) equal, the mixer up to its norm is
    the one-group mixer's; the norm is then taken per group."""
    one = make()
    two = make(groups=2)
    pre, N, d_inner = "layers.0.mamba", STATE, EXPAND * D
    for k in ("in_z.w", "in_x.w", "in_dt.w", "a_log", "dt_bias", "d_skip", "norm.g",
              "out_proj.w"):
        two[f"{pre}.{k}"] = one[f"{pre}.{k}"]
    w, cw, cb = one[f"{pre}.in_bc.w"], one[f"{pre}.conv_w"], one[f"{pre}.conv_b"]
    two[f"{pre}.in_bc.w"] = torch.cat([w[:, :N], w[:, :N], w[:, N:], w[:, N:]], dim=1)
    bc = [slice(d_inner, d_inner + N), slice(d_inner + N, None)]
    two[f"{pre}.conv_w"] = torch.cat([cw[:, :d_inner]] + [cw[:, bc[0]]] * 2
                                     + [cw[:, bc[1]]] * 2, dim=1)
    two[f"{pre}.conv_b"] = torch.cat([cb[:d_inner]] + [cb[bc[0]]] * 2 + [cb[bc[1]]] * 2)
    x = _inputs()

    def ungated(p, prefix, y, z, groups, eps, gate_first):
        return y * F.silu(z)

    with monkeypatch.context() as m:
        m.setattr(reference, "_gated_norm", ungated)
        assert torch.allclose(mixer(two, x, groups=2), mixer(one, x), rtol=0, atol=1e-6)
    # the norm per group: each half of the channels by its own mean square
    g = {"mamba.norm.g": one[f"{pre}.norm.g"]}
    y, z = torch.randn(2, 2, 3, d_inner, generator=torch.Generator().manual_seed(4))
    halves = [reference._gated_norm({"mamba.norm.g": g["mamba.norm.g"][h]}, "mamba",
                                    y[..., h], z[..., h], 1, 1e-6, True)
              for h in (slice(0, d_inner // 2), slice(d_inner // 2, None))]
    grouped = reference._gated_norm(g, "mamba", y, z, 2, 1e-6, True)
    assert torch.allclose(grouped, torch.cat(halves, -1), rtol=0, atol=1e-6)
    assert not torch.allclose(grouped, reference._gated_norm(g, "mamba", y, z, 1, 1e-6, True))


def test_the_recurrence_is_the_published_one_step_by_step():
    """One head, one channel, one state: y_t = h_t c_t + D x_t with
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_t, written out by hand."""
    xs, dts, bs, cs = [1.0, -2.0, 0.5], [0.1, 0.2, 0.3], [2.0, 1.0, -1.0], [0.5, 1.5, 2.0]
    x, b, c = (torch.tensor(v).view(1, 3, 1, 1) for v in (xs, bs, cs))
    y = reference._ssd(x, torch.tensor(dts).view(1, 3, 1), torch.tensor([-2.0]), b, c,
                       torch.tensor([0.3]))
    h, want = 0.0, []
    for xt, dt, bt, ct in zip(xs, dts, bs, cs, strict=True):
        h = math.exp(dt * -2.0) * h + dt * xt * bt
        want.append(h * ct + 0.3 * xt)
    assert y.flatten().tolist() == pytest.approx(want, rel=1e-6)
