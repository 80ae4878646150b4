"""Weights of the cells' architectures, made on the device from the run's seed.

The benchmark makes the weights and hands the same values to the program
(copied into its parameters by name) and to the plain reference (made again,
group by group, from the same seed). An architecture's parameter layout
(names, shapes and dtypes in the port's order) is frozen in its reference
module, ``portbench/archs/<module>.py`` (``spec.reference_module``); the
harness refuses to run if the program's parameters differ from it.

Each group (the embeddings, one layer, the final norm and head) is one
``torch.randn`` on a generator seeded from (seed, stage, variant, group),
scaled by its kind: tables ``.e`` 0.02, gains ``.g`` 1 + 0.1 n, biases ``.b``
0.02 n, every matrix 1/sqrt(fan_in) (lecun-normal, as the port initialises).
A state-space layer's 1-D parameters take rules keyed on the last part of
their name, the port's Mamba2 names, with u = Phi(n) where a rule needs a
uniform draw: ``a_log`` log(1 + 15 u), so A = -exp(a_log) lies in [-16, -1]
(Mamba2's published ``A_init_range``); ``dt_bias`` the inverse softplus of
dt = exp(ln 1e-3 + u (ln 1e-1 - ln 1e-3)), floored at 1e-4 (Mamba2's
published init); ``d_skip`` 1 + 0.1 n (published 1; the spread makes every
head's skip term count); ``conv_b`` 0.02 n, as every bias. Any other
parameter under two dimensions is refused by name.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from portbench import spec

MASK64 = (1 << 64) - 1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def phys_experts(n: int) -> int:
    """Experts >= 16 are held padded to a multiple of 16, as the port lays
    them out; the router stays at the logical count."""
    return n if n < 16 else 16 * -(-n // 16)


def supported(arch: dict, config: dict | None = None, root: Path = spec.ROOT) -> bool:
    """Whether a plain reference covers the architecture."""
    return spec.reference_module(arch, config, root) is not None


def _norm(prefix: str, d: int, layernorm: bool, dt):
    out = [(f"{prefix}.g", (d,), dt)]
    return out + [(f"{prefix}.b", (d,), dt)] if layernorm else out


def _linear(prefix: str, i: int, o: int, bias: bool, dt):
    out = [(f"{prefix}.w", (i, o), dt)]
    return out + [(f"{prefix}.b", (o,), dt)] if bias else out


def _attention(prefix: str, d: int, h: int, kv: int, hd: int, bias: bool, dt):
    return (
        _linear(f"{prefix}.wq", d, h * hd, bias, dt)
        + _linear(f"{prefix}.wk", d, kv * hd, bias, dt)
        + _linear(f"{prefix}.wv", d, kv * hd, bias, dt)
        + _linear(f"{prefix}.wo", h * hd, d, False, dt)
    )


def _mlp(prefix: str, d: int, f: int, kind: str, dt):
    if kind == "swiglu":
        return (
            _linear(f"{prefix}.wg", d, f, False, dt)
            + _linear(f"{prefix}.wu", d, f, False, dt)
            + _linear(f"{prefix}.wd", f, d, False, dt)
        )
    return _linear(f"{prefix}.w1", d, f, True, dt) + _linear(f"{prefix}.w2", f, d, True, dt)


def layout(arch: dict, config: dict | None = None,
           root: Path = spec.ROOT) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of every parameter, in the port's order."""
    return spec.reference_for(arch, config, root).layout(arch)


def group_of(name: str, n_layers: int) -> int:
    """0 for the embeddings (and the vlm's projector), 1 + i for layer i,
    n_layers + 1 for the final norm and the head."""
    if name.startswith("layers."):
        return 1 + int(name.split(".")[1])
    if name.startswith(("ln_f.", "lm_head.")):
        return n_layers + 1
    return 0


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def key(seed: int, *parts: int) -> int:
    """A 63-bit generator seed from the run's seed and the parts."""
    x = _mix(int(seed) & MASK64)
    for p in parts:
        x = _mix(x ^ (int(p) & MASK64))
    return x >> 1


def _uniform(n: torch.Tensor) -> torch.Tensor:
    """Phi(n): a standard normal draw made uniform on (0, 1)."""
    return n.div_(math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5)


def _dt_bias(n: torch.Tensor) -> torch.Tensor:
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = _uniform(n).mul_(hi - lo).add_(lo).exp_().clamp_(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))  # softplus(dt_bias) = dt


# 1-D parameters of a state-space layer, by the last part of their name
STATE_SPACE = {
    "a_log": lambda n: _uniform(n).mul_(15.0).log1p_(),
    "dt_bias": _dt_bias,
    "d_skip": lambda n: n.mul_(0.1).add_(1.0),
    "conv_b": lambda n: n.mul_(0.02),
}


def _init(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.endswith(".e"):
        return x.mul_(0.02)
    if name.endswith(".g"):
        return x.mul_(0.1).add_(1.0)
    if name.endswith(".b"):
        return x.mul_(0.02)
    rule = STATE_SPACE.get(name.rsplit(".", 1)[-1])
    if rule is not None:
        return rule(x)
    if x.dim() < 2:
        raise ValueError(f"{name}: no rule makes a parameter of shape {tuple(x.shape)}")
    return x.mul_(x.shape[-2] ** -0.5)


def group(arch: dict, seed: int, stage: int, variant: int, index: int, device, params):
    """{name: tensor} of one group, in the dtypes the layout ``params`` gives."""
    items = [it for it in params if group_of(it[0], arch["n_layers"]) == index]
    numel = [int(torch.Size(shape).numel()) for _, shape, _ in items]
    gen = torch.Generator(device=device)
    gen.manual_seed(key(seed, stage, variant, index))
    flat = torch.randn(sum(numel), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, dt), n in zip(items, numel, strict=True):
        out[name] = _init(name, flat[off:off + n].view(shape)).to(dt)
        off += n
    return out


def fill(model: torch.nn.Module, arch: dict, seed: int, stage: int, variant: int,
         config: dict | None = None, root: Path = spec.ROOT):
    """Copy the benchmark's weights into the program's ``model``, after
    checking that its parameters are ``layout``'s."""
    params = dict(model.named_parameters())
    want = layout(arch, config, root)
    have = [(n, tuple(p.shape), p.dtype) for n, p in params.items()]
    if have != [(n, tuple(s), dt) for n, s, dt in want]:
        diff = sorted(set(have) ^ {(n, tuple(s), dt) for n, s, dt in want})[:6]
        raise RuntimeError(f"{arch['name']}: the program's parameters differ from "
                           f"the benchmark's layout: {diff}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for index in range(arch["n_layers"] + 2):
            for name, value in group(arch, seed, stage, variant, index, device, want).items():
                params[name].copy_(value)
