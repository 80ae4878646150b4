"""The sharded program held against the one-rank program: rank functions
for ``distributed.launch.run_on_mesh``, which the CPU tests and the card's
smoke test both run (a spawned rank imports this module, which imports
neither jax nor the JAX package).

Every rank builds the whole model (or layer) from the same seed, or from
carried weights, and runs the one-rank program on it first; then it keeps
its blocks (``sharding.place``) and runs the sharded program on the same
inputs. Routing a MoE is discontinuous (a choice near a tie turns on the
last bits of the hidden state, which a row-parallel sum rounds otherwise),
so the sharded run replays the one-rank run's dispatch plans
(``moe_plans``), cut to the rank's batch rows. Errors are max |a - b| over
max(1, max |b|). Rank 0 returns the results; the others return what they
launched.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops

moe_mod = importlib.import_module("repro_torch.nn.moe")    # nn exports the function ``moe``


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


@contextlib.contextmanager
def moe_plans(plans: list, replay: bool):
    """Record ``nn.moe._route``'s plans into ``plans`` or, with ``replay``,
    hand them back in order instead of routing; a rank that routes a block
    of the batch rows gets the plan's rows of its block."""
    route = moe_mod._route
    recorded = iter(list(plans))

    def planned(params, x, **kw):
        if not replay:
            plans.append(route(params, x, **kw))
            return plans[-1]
        gsel, tok, probs, C = next(recorded)
        if x.shape[0] != gsel.shape[0]:
            axes = col.batch_axes()
            gsel, tok, probs = (col.block(t, axes, 0) for t in (gsel, tok, probs))
        return gsel, tok, probs, C

    moe_mod._route = planned
    try:
        yield
    finally:
        moe_mod._route = route


def _local_rows(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    return shd.local_block(t, (shd._entry(axes) if axes else None,) + (None,) * (t.dim() - 1),
                           mesh)


def moe_layer(mesh, source, top_k: int, ep2d: bool = False):
    """One MoE layer from carried weights (``source``: the path of an
    ``.npz`` holding router ``w`` [d, E], ``wg``/``wu`` [E_phys, d, f],
    ``wd`` [E_phys, f, d] and ``x`` [B, S, d]; or a dict of ``numpy_moe``'s
    arguments, which every rank draws alike: arrays among a spawn's
    arguments slow every rank's start by seconds) on the one-rank path and
    sharded on ``mesh``: experts over
    "model" (``ep2d``: and d_ff over "data"), the rows over the data axes
    when they divide. -> rank 0: the sharded output (rows gathered) and
    ``lb_loss`` beside the one-rank ones."""
    dev = mesh.device
    arrays = dict(np.load(source)) if isinstance(source, str) else numpy_moe(**source)
    d, E = arrays["router"].shape
    m = moe_mod.MoE(d, arrays["wg"].shape[2], E, device=dev)
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(arrays["router"]))
        for k in ("wg", "wu", "wd"):
            getattr(m.experts, k).copy_(torch.from_numpy(arrays[k]))
    x = torch.from_numpy(arrays["x"]).to(dev)
    with torch.inference_mode():
        y_one, aux_one = moe_mod.moe(m, x, top_k=top_k, ep2d=ep2d)
    specs = ({"wg": ("model", None, "data"), "wu": ("model", None, "data"),
              "wd": ("model", "data", None)} if ep2d else
             dict.fromkeys(("wg", "wu", "wd"), ("model", None, None)))
    with torch.no_grad():
        for k, spec in specs.items():
            p = getattr(m.experts, k)
            p.data = shd.local_block(p.data, spec, mesh)
    rows = shd.batch_axes(x.shape[0], mesh)
    with torch.inference_mode(), col.use_mesh(mesh, batch_axes=rows):
        y, aux = moe_mod.moe(m, _local_rows(x, rows, mesh), top_k=top_k, ep2d=ep2d)
        y = col.gather(y, rows, 0)
    if mesh.rank:
        return None
    return {"y": y.cpu().numpy(), "lb_loss": float(aux["lb_loss"]),
            "dropped_frac": float(aux["dropped_frac"]), "y_one": y_one.cpu().numpy(),
            "lb_loss_one": float(aux_one["lb_loss"])}


def _blocks_whole(model, full: dict, specs: dict, mesh) -> float:
    """Largest error of a parameter rebuilt from every rank's block (its
    blocks gathered over each split dim's axes) against the whole one."""
    worst = 0.0
    with col.use_mesh(mesh):
        for name, p in model.named_parameters():
            t = p.data
            for dim, entry in enumerate(specs[name]):
                axes = shd._axes(entry)
                if axes:
                    t = col.gather(t, axes, dim)
            worst = max(worst, float((t - full[name]).abs().max()))
    return worst


def decoder(mesh, arch: str, *, smoke: bool = True, batch: int = 4, prompt: int = 16,
            steps: int = 8, seed: int = 0, overrides: dict | None = None,
            ring: bool = False):
    """A decoder-family model (f32, seed ``seed``; ``overrides`` replace
    fields of its config) on the one-rank path and
    sharded on ``mesh``: ``api.forward`` of a ``prompt``-token batch with
    and without ``shard_h``, then ``steps`` teacher-forced ``decode_step``s
    over a cache of ``prompt`` slots (``ring``: a ring buffer whose writes
    start 3 slots before its end, so that they wrap). -> per rank: errors against the
    one-rank run (rank 0), the bytes the rank holds against the rules',
    and the parameters rebuilt from every rank's blocks against the whole
    ones."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models.config import InputShape
    dev = mesh.device
    cfg = (ARCHS[arch].smoke() if smoke else ARCHS[arch]).replace(**(overrides or {}))
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen).to(dev)
    fed = torch.randint(0, cfg.vocab, (steps, batch, 1), generator=gen).to(dev)
    model = api.init_model(seed, cfg, device=dev)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    fwd_plans, dec_plans = [], []
    with torch.inference_mode():
        with moe_plans(fwd_plans, replay=False):
            want_fwd, want_aux = api.forward(model, {"tokens": tokens}, cfg)
        cache = _start(api.init_cache(cfg, batch, prompt, device=dev), ring)
        want_dec = []
        with moe_plans(dec_plans, replay=False):
            for i in range(steps):
                logits, cache = api.decode_step(model, {"tokens": fed[i]}, cache, cfg,
                                                ring=ring)
                want_dec.append(logits)
    pshape = InputShape("prompt", prompt, batch, "prefill")
    dshape = InputShape("decode", prompt, batch, "decode")
    model, cache, _ = shd.place(model, mesh, cfg=cfg, kind="decode",
                                cache=_start(api.init_cache(cfg, batch, prompt, device=dev),
                                             ring))
    abstract = shd.abstract_params(cfg)
    specs = shd.param_shardings(cfg, mesh, kind="decode", params=abstract)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    rule = shd.tree_shard_bytes(abstract, specs, mesh)
    cache_held = sum(t.numel() * t.element_size() for t in cache.values())
    cache_rule = shd.tree_shard_bytes(
        shd.abstract_cache(cfg, dshape),
        shd.cache_shardings(cfg, dshape, mesh), mesh)
    axes = shd.program_axes(cfg, dshape, mesh)
    rows = axes["batch_axes"]
    ops.reset_launch_counts()
    errs = {}
    with torch.inference_mode(), col.use_mesh(mesh, **axes):
        x = {"tokens": _local_rows(tokens, rows, mesh)}
        for name, shard_h in (("forward", None),
                              ("forward_shard_h", shd.residual_constraint(cfg, pshape, mesh))):
            with moe_plans(fwd_plans, replay=True):
                got, aux = api.forward(model, x, cfg, shard_h=shard_h)
            errs[name] = rel_err(col.gather(got, rows, 0), want_fwd)
            errs[name + "_lb_loss"] = abs(float(aux["lb_loss"]) - float(want_aux["lb_loss"]))
        got_dec = []
        with moe_plans(dec_plans, replay=True):
            for i in range(steps):
                logits, cache = api.decode_step(
                    model, {"tokens": _local_rows(fed[i], rows, mesh)}, cache, cfg, ring=ring)
                got_dec.append(col.gather(logits, rows, 0))
        errs["decode"] = max(rel_err(g, w) for g, w in zip(got_dec, want_dec, strict=True))
    out = {"rank": mesh.rank, "launches": ops.launch_counts(), "param_bytes": held,
           "param_bytes_rule": rule, "cache_bytes": cache_held, "cache_bytes_rule": cache_rule,
           "finite": bool(all(torch.isfinite(t).all() for t in got_dec)),
           "blocks_err": _blocks_whole(model, full, specs, mesh)}
    if mesh.rank == 0:
        out["errs"] = errs
    return out


def _start(cache: dict, ring: bool) -> dict:
    """A fresh cache; a ring's writes start 3 slots before its end."""
    if ring:
        cache["pos"].fill_(cache["k"].shape[2] - 3)
    return cache


def decoders(mesh, cases: list[tuple[str, dict, dict]]) -> list[dict]:
    """``decoder`` for each (arch, overrides, keywords) of ``cases`` in one
    launch."""
    return [decoder(mesh, arch, overrides=over, **kw) for arch, over, kw in cases]


def stage(mesh, arch: str, *, batch: int = 4, steps: int = 8, prompt: int = 32,
          seq_len: int = 32, smoke: bool = False):
    """``cluster.executor.StageExecutor`` on ``mesh`` against the one-rank
    executor, f32 weights (``quant="f32"``) from seed 0 on both:
    ``steps`` teacher-forced decode steps of
    its compiled serving step at ``batch`` (cache of ``seq_len`` slots),
    then one ``prompt``-token ``api.forward`` with ``shard_h``; every
    rank's flash and decode launches in the sharded run, the slowest
    rank's step time (``StageExecutor.measure``), the rank's weight bytes.
    -> per rank a dict; rank 0's holds the errors."""
    from repro_torch.cluster.executor import StageExecutor
    from repro_torch.models import api, steps as msteps
    from repro_torch.models.config import InputShape
    dev, quant = mesh.device, "f32"
    one = StageExecutor(dev, seq_len=seq_len, smoke=smoke)
    cfg = one.arch_config(arch)
    gen = torch.Generator().manual_seed(7)
    fed = torch.randint(0, cfg.vocab, (steps, batch, 1), generator=gen).to(dev)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen).to(dev)
    dshape = InputShape(f"serve_b{batch}", seq_len, batch, "decode")
    step = msteps.make_serve_step(cfg, dshape)
    dec_plans, fwd_plans = [], []
    with torch.inference_mode():
        model = one.params_for(arch, quant)
        _, cache = one._inputs(cfg, dshape)
        want_dec = []
        with moe_plans(dec_plans, replay=False):
            for i in range(steps):
                logits, cache = step(model, {"tokens": fed[i]}, cache)
                want_dec.append(logits.cpu())
        with moe_plans(fwd_plans, replay=False):
            want_fwd = api.forward(model, {"tokens": tokens}, cfg)[0].cpu()
    del model, cache, one
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ex = StageExecutor(dev, seq_len=seq_len, smoke=smoke, mesh=mesh)
    entry, _ = ex.compiled_step(arch, batch, quant)
    rows = entry.axes["batch_axes"]
    ops.reset_launch_counts()
    errs = {}
    with torch.inference_mode(), col.use_mesh(mesh, **entry.axes):
        cache = {k: v.zero_() for k, v in entry.cache.items()}
        got = []
        with moe_plans(dec_plans, replay=True):
            for i in range(steps):
                logits, cache = entry.step(entry.model, {"tokens": _local_rows(
                    fed[i], rows, mesh)}, cache)
                got.append(col.gather(logits, rows, 0).cpu())
        dec_launches = ops.launch_counts()
        errs["decode"] = max(rel_err(g, w) for g, w in zip(got, want_dec, strict=True))
        pshape = InputShape("prompt", prompt, batch, "prefill")
        with moe_plans(fwd_plans, replay=True):
            logits, _ = api.forward(entry.model, {"tokens": _local_rows(tokens, rows, mesh)},
                                    cfg, shard_h=shd.residual_constraint(cfg, pshape, mesh))
        errs["forward_shard_h"] = rel_err(col.gather(logits, rows, 0), want_fwd)
    launches = ops.launch_counts()
    finite = bool(all(torch.isfinite(g).all() for g in got)) and bool(
        torch.isfinite(logits).all())
    t0 = time.perf_counter()
    timing = ex.measure(arch, batch, quant, reps=3, warmup=1)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
           "launches": launches, "decode_launches": dec_launches,
           "weight_gib": sum(p.numel() * p.element_size()
                             for p in entry.model.parameters()) / 2 ** 30,
           "step_ms": timing.latency_s * 1e3, "measure_s": time.perf_counter() - t0,
           "device_class": ex.device_class, "finite": finite,
           "cache_key_mesh": list(ex.key_for(arch, batch, quant).mesh)}
    if mesh.rank == 0:
        out["errs"] = errs
    return out


def numpy_moe(seed: int, d: int, f: int, E: int, shape) -> dict:
    """Seeded NumPy weights and input for ``moe_layer`` (lecun-normal
    scales, as the layer's init; E experts padded as the layer pads them)."""
    rng = np.random.default_rng(seed)
    E_phys = moe_mod._phys_experts(E)
    return {"router": (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32),
            "wg": (rng.standard_normal((E_phys, d, f)) / np.sqrt(d)).astype(np.float32),
            "wu": (rng.standard_normal((E_phys, d, f)) / np.sqrt(d)).astype(np.float32),
            "wd": (rng.standard_normal((E_phys, f, d)) / np.sqrt(f)).astype(np.float32),
            "x": rng.standard_normal(shape).astype(np.float32)}
