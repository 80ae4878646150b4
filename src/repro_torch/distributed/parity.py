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
launched. ``train`` holds the sharded train step so, every rank its own
blocks of the gradients, parameters and moments; its one-rank run
(``train_reference``) can also come from a file, where it is too large to
repeat in every rank (the card's full-width models).
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
from repro_torch.launch import step_cost

moe_mod = importlib.import_module("repro_torch.nn.moe")    # nn exports the function ``moe``


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|), in float64 on ``got``'s
    device."""
    got = got.detach().double()
    want = want.detach().to(got.device, torch.float64)
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


@contextlib.contextmanager
def moe_plans(plans: list, replay: bool):
    """Record ``nn.moe._route``'s plans into ``plans`` or, with ``replay``,
    hand their choices back in order instead of choosing: each token's
    top-k experts (from the recorded router probabilities) and each
    expert's tokens, with the gates recomputed from this run's router, so
    a replayed step differentiates through the router as the recorded one
    does. A rank that routes a block of the batch rows gets the plan's
    rows of its block."""
    route = moe_mod._route
    recorded = iter(list(plans))

    def planned(params, x, **kw):
        if not replay:
            plan = route(params, x, **kw)
            plans.append(tuple(t.detach() if isinstance(t, torch.Tensor) else t
                               for t in plan))
            return plan
        _, tok, probs, C = next(recorded)
        if x.shape[0] != tok.shape[0]:
            axes = col.batch_axes()
            tok, probs = (col.block(t, axes, 0) for t in (tok, probs))
        tok, probs = tok.to(x.device), probs.to(x.device)
        now = moe_mod.router_probs(params, x)
        _, top_e = moe_mod._top_k(probs, kw["top_k"])
        gates = moe_mod.gates_of(now, top_e, kw["E_phys"])
        return torch.gather(gates.transpose(1, 2), 2, tok), tok, now, C

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


def _tree_err(got, want) -> float:
    """The largest ``rel_err`` over the matching tensors of two nests."""
    if isinstance(got, dict):
        return max(_tree_err(got[k], want[k]) for k in got)
    if isinstance(got, (list, tuple)):
        return max(_tree_err(g, w) for g, w in zip(got, want, strict=True))
    return rel_err(got, want)


def extra_inputs(cfg, batch: int, gen: torch.Generator, device) -> dict:
    """A prefill batch's inputs besides the tokens, drawn from ``gen``: the
    vlm's projected patches ``vision_embeds`` [B, P, d], the audio family's
    encoder frames ``enc_states`` [B, enc_len, d] (unit normal, f32)."""
    if cfg.family == "vlm":
        return {"vision_embeds": torch.randn(batch, cfg.n_patches, cfg.d_model,
                                             generator=gen).to(device)}
    if cfg.family == "audio":
        return {"enc_states": torch.randn(batch, cfg.enc_len, cfg.d_model,
                                          generator=gen).to(device)}
    return {}


def prompt_len(cfg, tokens: int) -> int:
    """Positions a prefill of ``tokens`` tokens runs over: the vlm's patches
    and its tokens."""
    return tokens + (cfg.n_patches if cfg.family == "vlm" else 0)


def decoder(mesh, arch: str, *, smoke: bool = True, batch: int = 4, prompt: int = 16,
            steps: int = 8, seed: int = 0, overrides: dict | None = None,
            ring: bool = False):
    """A model of any family (f32, seed ``seed``; ``overrides`` replace
    fields of its config) on the one-rank path and sharded on ``mesh``:
    ``api.forward`` of a ``prompt``-token batch (with its
    ``extra_inputs``) with and without ``shard_h``, and
    ``make_prefill_step``'s last-position logits (with the width of the
    logits its forward returned, a vocab block where the ``lm_head`` is
    vocab-split) and what it returns beside them (the rank's block of the
    collected or cross-attention cache against the one-rank cache's block,
    or the aux), then ``steps`` teacher-forced ``decode_step``s over a
    cache of ``prompt`` slots (the audio family's: the prefill's, so that
    the cross-attention reads the encoder; ``ring``: a ring buffer whose
    writes start 3 slots before its end, so that they wrap). -> per rank:
    errors against the one-rank run (rank 0), the bytes the rank holds
    against the rules', and the parameters rebuilt from every rank's
    blocks against the whole ones."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models import steps as msteps
    from repro_torch.models.config import InputShape
    dev = mesh.device
    cfg = (ARCHS[arch].smoke() if smoke else ARCHS[arch]).replace(**(overrides or {}))
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen).to(dev)
    fed = torch.randint(0, cfg.vocab, (steps, batch, 1), generator=gen).to(dev)
    whole = {"tokens": tokens, **extra_inputs(cfg, batch, gen, dev)}
    audio = cfg.family == "audio"
    model = api.init_model(seed, cfg, device=dev)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    fwd_plans, dec_plans = [], []
    with torch.inference_mode():
        with moe_plans(fwd_plans, replay=False):
            want_fwd, want_aux = api.forward(model, whole, cfg)
        want_pre = msteps.make_prefill_step(cfg)(model, whole)[1]
        cache = (msteps.whisper.prefill_cache(model, whole, cfg, prompt) if audio else
                 _start(api.init_cache(cfg, batch, prompt, device=dev), ring))
        want_dec = []
        with moe_plans(dec_plans, replay=False):
            for i in range(steps):
                logits, cache = api.decode_step(model, {"tokens": fed[i]}, cache, cfg,
                                                ring=ring)
                want_dec.append(logits)
    S = prompt_len(cfg, prompt)
    pshape = InputShape("prompt", S, batch, "prefill")
    dshape = InputShape("decode", prompt, batch, "decode")
    model, cache, _ = shd.place(model, mesh, cfg=cfg, kind="decode",
                                cache=None if audio else _start(
                                    api.init_cache(cfg, batch, prompt, device=dev), ring))
    abstract = shd.abstract_params(cfg)
    specs = shd.param_shardings(cfg, mesh, kind="decode", params=abstract)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    rule = shd.tree_shard_bytes(abstract, specs, mesh)
    cache_rule = shd.tree_shard_bytes(
        shd.abstract_cache(cfg, dshape),
        shd.cache_shardings(cfg, dshape, mesh), mesh)
    axes = shd.program_axes(cfg, dshape, mesh)
    rows = axes["batch_axes"]
    ops.reset_launch_counts()
    errs = {}
    with torch.inference_mode(), col.use_mesh(mesh, **axes):
        x = {k: _local_rows(v, rows, mesh) for k, v in whole.items()}
        for name, shard_h in (("forward", None),
                              ("forward_shard_h", shd.residual_constraint(cfg, pshape, mesh))):
            with moe_plans(fwd_plans, replay=True):
                got, aux = api.forward(model, x, cfg, shard_h=shard_h)
            errs[name] = rel_err(col.gather(got, rows, 0), want_fwd)
            errs[name + "_lb_loss"] = abs(float(aux["lb_loss"]) - float(want_aux["lb_loss"]))
        sh = shd.residual_constraint(cfg, pshape, mesh)
        with moe_plans(fwd_plans, replay=True):
            last, pre = msteps.make_prefill_step(cfg, shard_h=sh)(model, x)
        with moe_plans(fwd_plans, replay=True):      # the logits the prefill step takes
            width = api.forward(model, x, cfg, shard_h=sh, vocab_block=True)[0].shape[-1]
        errs["prefill_last"] = rel_err(col.gather(last, rows, 0), want_fwd[:, -1])
        if "pos" in want_pre:                        # a cache: the rank's block of it
            cshape = InputShape("prefilled", S, batch, "decode")
            want_blocks = shd._blocks(want_pre, shd.cache_shardings(
                cfg, cshape, mesh, cache=want_pre), mesh, dev)
            errs["prefill_cache"] = _tree_err(pre, want_blocks)
        else:
            errs["prefill_aux"] = max(abs(float(pre[k]) - float(want_pre[k])) for k in pre)
        if audio:                                    # decode reads the prefill's cache
            cache = pre
        cache_held = sum(step_cost.nbytes(t) for t in step_cost.tensors(cache))
        got_dec = []
        with moe_plans(dec_plans, replay=True):
            for i in range(steps):
                logits, cache = api.decode_step(
                    model, {"tokens": _local_rows(fed[i], rows, mesh)}, cache, cfg, ring=ring)
                got_dec.append(col.gather(logits, rows, 0))
        errs["decode"] = max(rel_err(g, w) for g, w in zip(got_dec, want_dec, strict=True))
    out = {"rank": mesh.rank, "launches": ops.launch_counts(), "param_bytes": held,
           "prefill_logits_width": width,
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


def carried(mesh, path: str) -> dict | None:
    """The sharded program of a smoke model with carried weights and inputs
    (``path``: a ``torch.save``d {"arch", "overrides", "params" (whole
    tensors by name), "batch" (whole prefill inputs), "fed" [steps, B, 1],
    "context"}): ``api.forward`` with ``shard_h``, then ``len(fed)``
    teacher-forced decode steps over a cache of ``context`` slots (the
    audio family's from its sharded ``prefill_cache``). -> rank 0: both
    logits, rows gathered, as NumPy arrays; the other ranks: None."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api, whisper
    from repro_torch.models.config import InputShape
    dev = mesh.device
    src = torch.load(path, map_location="cpu")
    cfg = ARCHS[src["arch"]].smoke().replace(**src["overrides"])
    model = api.init_model(0, cfg, device=dev)
    model.load_state_dict(src["params"], strict=True)
    whole = {k: v.to(dev) for k, v in src["batch"].items()}
    fed, C = src["fed"].to(dev), src["context"]
    B, S = whole["tokens"].shape
    audio = cfg.family == "audio"
    model, cache, _ = shd.place(model, mesh, cfg=cfg, kind="decode",
                                cache=None if audio else api.init_cache(cfg, B, C, device=dev))
    axes = shd.program_axes(cfg, InputShape("decode", C, B, "decode"), mesh)
    rows = axes["batch_axes"]
    sh = shd.residual_constraint(cfg, InputShape("prompt", prompt_len(cfg, S), B, "prefill"),
                                 mesh)
    with torch.inference_mode(), col.use_mesh(mesh, **axes):
        x = {k: _local_rows(v, rows, mesh) for k, v in whole.items()}
        fwd = col.gather(api.forward(model, x, cfg, shard_h=sh)[0], rows, 0)
        if audio:
            cache = whisper.prefill_cache(model, x, cfg, C)
        dec = []
        for t in fed:
            logits, cache = api.decode_step(model, {"tokens": _local_rows(t, rows, mesh)},
                                            cache, cfg)
            dec.append(col.gather(logits, rows, 0))
    if mesh.rank:
        return None
    return {"forward": fwd.cpu().numpy(), "decode": torch.stack(dec).cpu().numpy()}


@contextlib.contextmanager
def lse_calls(counter: dict):
    """Count, in ``counter["lse"]``, the calls of the decode kernel's
    entry point that ask for its log-sum-exp (the decode merged across
    ranks; each such call on a CUDA tensor is one launch)."""
    fn = ops.decode_attention

    def counted(*args, **kw):
        if kw.get("return_lse"):
            counter["lse"] += 1
        return fn(*args, **kw)

    ops.decode_attention = counted
    try:
        yield counter
    finally:
        ops.decode_attention = fn


def _fill_cross(cache: dict, seed: int = 8) -> None:
    """Encoder keys and values (unit normal from ``seed``) in an audio
    cache's whole ``ck``/``cv``, so that its decode's cross-attention reads
    them."""
    gen = torch.Generator().manual_seed(seed)
    for k in ("ck", "cv"):
        if k in cache:
            cache[k].copy_(torch.randn(cache[k].shape, generator=gen).to(cache[k]))


def _executor(dev, *, seq_len: int, smoke: bool, overrides: dict | None, **kw):
    """A ``StageExecutor`` whose configs take ``overrides`` (a cut depth)."""
    from repro_torch.cluster.executor import StageExecutor
    ex = StageExecutor(dev, seq_len=seq_len, smoke=smoke, **kw)
    if overrides:
        base = ex.arch_config
        ex.arch_config = lambda a: base(a).replace(**overrides)
    return ex


def _stage_inputs(cfg, batch: int, steps: int, prompt: int, dev):
    """``stage``'s inputs, drawn from seed 7: the fed decode tokens [steps,
    batch, 1] and the prefill batch (``prompt`` tokens and the family's
    ``extra_inputs``)."""
    gen = torch.Generator().manual_seed(7)
    fed = torch.randint(0, cfg.vocab, (steps, batch, 1), generator=gen).to(dev)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen).to(dev)
    return fed, {"tokens": tokens, **extra_inputs(cfg, batch, gen, dev)}


@contextlib.contextmanager
def plain_attention():
    """Route ``kernels.ops``' attention to the kernels' plain versions on
    every device: a precision check's float64 runs, which no kernel takes.
    Nothing on the serving path uses this."""
    from repro_torch.kernels import ref
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention, ops.decode_attention = (ref.flash_attention_ref,
                                                 ref.decode_attention_ref)
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def precision(mesh, arch: str, *, batch: int = 4, steps: int = 8, prompt: int = 32,
              seq_len: int = 32, smoke: bool = False, overrides: dict | None = None):
    """How far f32 rounding alone moves ``stage``'s prefill (the same seed-0
    weights and inputs, ``api.forward`` with ``shard_h`` on the mesh):
    the one-rank f32 forward through the kernels and through their plain
    versions, the same weights in float64 (plain attention: no kernel takes
    float64) one-rank and sharded, and the sharded f32 forward again. ->
    rank 0: each run's distance (``rel_err``) from the one-rank float64
    run, the two one-rank f32 runs' from each other, and the sharded runs'
    from the one-rank run of their dtype; the other ranks: None. Not for the
    audio family, whose config's dtype casts the encoder states."""
    from repro_torch.models import api
    from repro_torch.models.config import InputShape
    dev = mesh.device
    one = _executor(dev, seq_len=seq_len, smoke=smoke, overrides=overrides)
    cfg = one.arch_config(arch)
    _, whole = _stage_inputs(cfg, batch, steps, prompt, dev)
    dshape = InputShape(f"serve_b{batch}", seq_len, batch, "decode")
    axes = shd.program_axes(cfg, dshape, mesh)
    rows = axes["batch_axes"]
    sh = shd.residual_constraint(cfg, InputShape("prompt", prompt_len(cfg, prompt), batch,
                                                 "prefill"), mesh)

    def wide(batch_in):
        return {k: v.double() if v.is_floating_point() else v for k, v in batch_in.items()}

    def sharded(model, batch_in):
        with col.use_mesh(mesh, **axes):
            x = {k: _local_rows(v, rows, mesh) for k, v in batch_in.items()}
            return col.gather(api.forward(model, x, cfg, shard_h=sh)[0], rows, 0)

    with torch.inference_mode():
        model = one.params_for(arch, "f32")
        f32 = api.forward(model, whole, cfg)[0]
        with plain_attention():
            f32_plain = api.forward(model, whole, cfg)[0]
            model.double()                        # in place: f32 -> f64 is exact
            f64 = api.forward(model, wide(whole), cfg)[0]
            model, _, _ = shd.place(model, mesh, cfg=cfg, kind="decode")
            f64_sharded = sharded(model, wide(whole))
        model.float()                             # back to the f32 weights, exactly
        f32_sharded = sharded(model, whole)
    if mesh.rank:
        return None
    return {"one_f32_vs_f64": rel_err(f32, f64), "one_f32_plain_vs_f64": rel_err(f32_plain, f64),
            "one_f32_vs_plain": rel_err(f32, f32_plain),
            "sharded_f32_vs_f64": rel_err(f32_sharded, f64),
            "sharded_f64_vs_one_f64": rel_err(f64_sharded, f64),
            "sharded_f32_vs_one_f32": rel_err(f32_sharded, f32)}


def stage(mesh, arch: str, *, batch: int = 4, steps: int = 8, prompt: int = 32,
          seq_len: int = 32, smoke: bool = False, overrides: dict | None = None):
    """``cluster.executor.StageExecutor`` on ``mesh`` against the one-rank
    executor, f32 weights (``quant="f32"``) from seed 0 on both:
    ``steps`` teacher-forced decode steps of its compiled serving step at
    ``batch`` (cache of ``seq_len`` slots; the audio family's cross-
    attention cache filled from a seed), then one ``prompt``-token
    ``api.forward`` with ``shard_h`` (and the family's ``extra_inputs``: a
    vlm's patches come before the tokens); every rank's flash and decode
    launches in the sharded run (the decode calls with lse beside them),
    the slowest rank's step time (``StageExecutor.measure``), the rank's
    weight bytes. ``overrides`` replace fields of the config on both (a
    cut depth). -> per rank a dict; rank 0's holds the errors."""
    from repro_torch.models import api, steps as msteps
    from repro_torch.models.config import InputShape
    dev, quant = mesh.device, "f32"

    def executor(**kw):
        return _executor(dev, seq_len=seq_len, smoke=smoke, overrides=overrides, **kw)

    one = executor()
    cfg = one.arch_config(arch)
    fed, whole = _stage_inputs(cfg, batch, steps, prompt, dev)
    dshape = InputShape(f"serve_b{batch}", seq_len, batch, "decode")
    step = msteps.make_serve_step(cfg, dshape)
    dec_plans, fwd_plans = [], []
    with torch.inference_mode():
        model = one.params_for(arch, quant)
        _, cache = one._inputs(cfg, dshape)
        _fill_cross(cache)
        want_dec = []
        with moe_plans(dec_plans, replay=False):
            for i in range(steps):
                logits, cache = step(model, {"tokens": fed[i]}, cache)
                want_dec.append(logits.cpu())
        with moe_plans(fwd_plans, replay=False):
            want_fwd = api.forward(model, whole, cfg)[0].cpu()
    del model, cache, one
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ex = executor(mesh=mesh)
    entry, _ = ex.compiled_step(arch, batch, quant)
    rows = entry.axes["batch_axes"]
    ops.reset_launch_counts()
    errs, lse = {}, {"lse": 0}
    with torch.inference_mode(), col.use_mesh(mesh, **entry.axes), lse_calls(lse):
        _, cache = ex._inputs(cfg, dshape)          # a fresh cache, placed
        _fill_cross(cache)
        got = []
        with moe_plans(dec_plans, replay=True):
            for i in range(steps):
                logits, cache = entry.step(entry.model, {"tokens": _local_rows(
                    fed[i], rows, mesh)}, cache)
                got.append(col.gather(logits, rows, 0).cpu())
        dec_launches = ops.launch_counts()
        errs["decode"] = max(rel_err(g, w) for g, w in zip(got, want_dec, strict=True))
        pshape = InputShape("prompt", prompt_len(cfg, prompt), batch, "prefill")
        with moe_plans(fwd_plans, replay=True):
            logits, _ = api.forward(entry.model, {k: _local_rows(v, rows, mesh)
                                                  for k, v in whole.items()},
                                    cfg, shard_h=shd.residual_constraint(cfg, pshape, mesh))
        errs["forward_shard_h"] = rel_err(col.gather(logits, rows, 0), want_fwd)
    launches = ops.launch_counts()
    finite = bool(all(torch.isfinite(g).all() for g in got)) and bool(
        torch.isfinite(logits).all())
    t0 = time.perf_counter()
    timing = ex.measure(arch, batch, quant, reps=3, warmup=1)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
           "launches": launches, "decode_launches": dec_launches, "lse_calls": lse["lse"],
           "cache_axes": list(entry.axes["cache_axes"]),
           "weight_gib": sum(p.numel() * p.element_size()
                             for p in entry.model.parameters()) / 2 ** 30,
           "step_ms": timing.latency_s * 1e3, "measure_s": time.perf_counter() - t0,
           "device_class": ex.device_class, "finite": finite,
           "cache_key_mesh": list(ex.key_for(arch, batch, quant).mesh)}
    if mesh.rank == 0:
        out["errs"] = errs
    return out


def stages(mesh, cases: list[tuple[str, dict, dict]]) -> list[dict]:
    """``stage`` for each (arch, overrides, keywords) of ``cases`` in one
    launch (the models one after another: a rank frees each before the
    next)."""
    out = []
    for arch, over, kw in cases:
        out.append(stage(mesh, arch, overrides=over or None, **kw))
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
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


def numpy_lm_batch(seed: int, cfg, batch: int, seq: int, *, uneven: bool = False) -> dict:
    """Seeded NumPy train inputs of ``seq`` text tokens a row: tokens [batch,
    seq] and labels (int32), then the family's inputs besides the tokens
    (unit normal, f32): the vlm's ``vision_embeds`` [batch, P, d], whose
    patches come first in the sequence, so its labels are [batch, P + seq]
    with -100 on the patch positions; the audio family's ``enc_states``
    [batch, enc_len, d]. ``uneven`` masks text labels (-100) unevenly over
    the rows: most of row 0, half of row 1, none below, so the data ranks
    hold different valid counts. Every device reads the same arrays (a CUDA
    generator draws other numbers than a CPU one)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    if uneven:
        labels[0, 1:] = -100
        labels[1, : seq // 2] = -100
    out = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        out["labels"] = np.concatenate(
            [np.full((batch, cfg.n_patches), -100, np.int32), labels], axis=1)
        out["vision_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["enc_states"] = rng.standard_normal(
            (batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


NEAR_ZERO = 100 * 1e-8      # a clipped gradient this close to 0 (not 0) meets AdamW's eps


def _state(model, opt, near) -> dict:
    """The whole model's parameters and moments after a step, and where
    some step's gradient lay within NEAR_ZERO of 0, on the CPU."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    return {"params": {n: host(p) for n, p in model.named_parameters()},
            "m": {n: host(t) for n, t in opt["m"].items()},
            "v": {n: host(t) for n, t in opt["v"].items()},
            "near": {n: host(t) for n, t in near.items()}}


def train_reference(cfg, model, batch: dict, *, steps: int = 2,
                    microbatch: int | None = None, grads: bool = True,
                    keep=None) -> dict:
    """The one-rank train step on ``model`` (updated in place) for ``steps``
    steps -> {"metrics": [{loss, grad_norm}] per step, "states": [params
    and moments per step, on the CPU; None for a step not in ``keep``
    (default: every step)], "grads": the first step's gradients (with
    ``grads``), "plans": the MoE plans of the gradient step and of each
    step, "step_s": each step's wall (synchronised on a card)}. A state's
    "near" marks the elements where some step so far took a clipped
    gradient within NEAR_ZERO of 0 but not 0: there AdamW's update
    g / (|g| + eps) turns the gradient's last bits into a move of up to
    ``lr``."""
    from repro_torch.models import steps as msteps
    from repro_torch.train import adamw_init
    cuda = next(model.parameters()).device.type == "cuda"
    out = {"metrics": [], "states": [], "plans": {"grads": [], "steps": []}, "step_s": []}
    if grads:
        with moe_plans(out["plans"]["grads"], replay=False):
            _, _, g = msteps.make_grad_step(cfg, microbatch=microbatch)(model, batch)
        out["grads"] = {n: t.cpu() for n, t in g.items()}
        del g
    step = msteps.make_train_step(cfg, microbatch=microbatch)
    opt = adamw_init(model)
    near = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in model.named_parameters()}
    for i in range(steps):
        m_before = {n: t.clone() for n, t in opt["m"].items()}
        plans = []
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe_plans(plans, replay=False):
            model, opt, met = step(model, opt, batch)
        if cuda:
            torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["plans"]["steps"].append(plans)
        out["metrics"].append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
        for n, m in opt["m"].items():       # the clipped gradient AdamW took: (m' - b1 m) / (1 - b1)
            g = (m - 0.9 * m_before[n]) / 0.1
            near[n] |= (g.abs() < NEAR_ZERO) & (g != 0)
        del m_before
        out["states"].append(_state(model, opt, near) if keep is None or i in keep else None)
    return out


def _worst(got: dict, want: dict, specs: dict, mesh, near: dict | None = None
           ) -> tuple[float, str, float, int]:
    """(largest ``rel_err`` of a rank's blocks against the rank's blocks of
    the whole tensors, the name where it is, and, where ``near`` marks
    elements, the largest absolute error there and their count: those are
    left out of the first)."""
    worst, where, worst_near, n_near = 0.0, "", 0.0, 0
    for n, t in got.items():
        t = t.detach()
        w = shd.local_block(want[n], specs[n], mesh).to(t.device)
        if near is not None:
            mask = shd.local_block(near[n], specs[n], mesh).to(t.device)
            k = int(mask.sum())
            n_near += k
            if k:
                worst_near = max(worst_near, float((t.double() - w.double())[mask].abs().max()))
                w = torch.where(mask, t.to(w.dtype), w)
        e = rel_err(t, w)
        if e > worst or not where:
            worst, where = e, n
    return worst, where, worst_near, n_near


def _counted_as_100b(cfg):
    """``cfg`` with ``param_count`` over 1e11: the rules' 100B+ layouts at
    a small size."""
    import dataclasses

    class Counted(type(cfg)):
        def param_count(self) -> float:
            return 2e11

    return Counted(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def train(mesh, arch: str, *, smoke: bool = True, overrides: dict | None = None,
          batch: int = 4, seq: int = 16, microbatch: int | None = None,
          uneven: bool = False, carried: str | None = None, want: str | None = None,
          gather_moments: bool = True, fsdp: bool = False, steps: int = 2,
          check_grads: bool = True):
    """The train step sharded on ``mesh`` against the one-rank step from the
    same weights: a model placed by ``sharding.place(kind="train")``, ZeRO-1
    moments (``sharding.zero_layout``), the batch rows over the data axes
    and the sequence-parallel residual stream, ``steps`` steps at the train
    step's learning rate. Weights: ``init_model(0)`` on every rank alike, or
    ``carried`` (the path of a ``torch.save``d {"params": whole tensors by
    name, and the batch: "tokens", "labels" and the family's inputs besides
    the tokens}); the batch then comes from there too, else from
    ``numpy_lm_batch`` (``seq`` text tokens a row). The one-rank run:
    ``train_reference`` in the rank (on a card one rank at a time: ranks
    that share it would each hold a one-rank step's memory at once), or
    ``want`` (the path of its ``torch.save``d results, loaded with
    ``mmap``: each rank reads its blocks). -> per rank: errors of its
    gradient (one step, before clipping; with ``check_grads`` and no
    ``want``, which holds none), parameter and moment blocks after
    each step against the one-rank blocks, each relative to max(1, max
    |one-rank|), with the parameter where each is largest; a parameter's
    elements where the one-rank step took a gradient near 0 (the state's
    "near", ``train_reference``) are held apart, by their absolute error
    (``near_<step>``) and count; the loss and
    ``grad_norm`` per step beside the one-rank ones; bytes held against
    the rules'; its step times beside the one-rank run's and (on a card)
    the peak it allocated over the steps. ``fsdp`` counts the config as a
    100B+ model, so the rules split its experts' train blocks over "data"
    too (the FSDP blocks the MoE gathers)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api
    from repro_torch.models import steps as msteps
    from repro_torch.models.config import InputShape
    from repro_torch.train import adamw_init
    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg = (ARCHS[arch].smoke() if smoke else ARCHS[arch]).replace(**(overrides or {}))
    if fsdp:
        cfg = _counted_as_100b(cfg)
    model = api.init_model(0, cfg, device=dev)
    if carried is not None:
        src = torch.load(carried, map_location="cpu")
        model.load_state_dict(src["params"], strict=True)
        whole = {k: v for k, v in src.items() if k != "params"}
    else:
        whole = {k: torch.from_numpy(v) for k, v in numpy_lm_batch(
            1, cfg, batch, seq, uneven=uneven).items()}
    whole = {k: v.to(dev) for k, v in whole.items()}
    if want is None:
        import copy
        import torch.distributed as dist
        serial = cuda and mesh.size > 1
        for turn in range(mesh.size if serial else 1):
            if not serial or turn == mesh.rank:
                ref = train_reference(cfg, copy.deepcopy(model), whole, steps=steps,
                                      microbatch=microbatch, grads=check_grads)
            if serial:
                torch.cuda.empty_cache()
                dist.barrier()
    else:
        ref = torch.load(want, map_location="cpu", mmap=True)
    # the residual stream runs over every position the labels cover (a vlm's
    # patches and its text), which decides the sequence split
    shape = InputShape("train", whole["labels"].shape[1], whole["labels"].shape[0], "train")
    multi_pod = "pod" in mesh.shape
    model, _, placed = shd.place(model, mesh, cfg=cfg, kind="train", batch=whole,
                                 multi_pod=multi_pod)
    del whole
    specs = shd.param_shardings(cfg, mesh, kind="train")
    zero = shd.zero_layout(cfg, mesh)
    mspecs = shd.opt_shardings(cfg, mesh, multi_pod=multi_pod)
    opt = adamw_init(model, zero=zero)
    abstract = shd.abstract_params(cfg)
    rule = {"params": shd.tree_shard_bytes(abstract, specs, mesh),
            "opt": 2 * sum(shd.shard_bytes(torch.empty(p.shape, dtype=torch.float32,
                                                       device="meta"), mspecs[n], mesh)
                           for n, p in abstract.items())}
    held = {"params": sum(p.numel() * p.element_size() for p in model.parameters()),
            "opt": sum(t.numel() * t.element_size() for k in ("m", "v")
                       for t in opt[k].values())}
    axes = shd.program_axes(cfg, shape, mesh, multi_pod=multi_pod)
    sh = shd.residual_constraint(cfg, shape, mesh, multi_pod=multi_pod)
    errs, metrics, where, walls, counts = {}, [], {}, [], {}
    plans = ref.get("plans")

    def replayed(kind, i=None):
        if plans is None:                   # the one-rank run's routing is not at hand
            return contextlib.nullcontext()
        return moe_plans(plans[kind] if i is None else plans[kind][i], replay=True)

    with col.use_mesh(mesh, **axes):
        if "grads" in ref:
            with replayed("grads"):
                _, _, grads = msteps.make_grad_step(cfg, shard_h=sh, microbatch=microbatch)(
                    model, placed)
            held["grads"] = sum(g.numel() * g.element_size() for g in grads.values())
            errs["grads"], where["grads"], _, _ = _worst(grads, ref["grads"], specs, mesh)
            del grads
        step = msteps.make_train_step(cfg, shard_h=sh, microbatch=microbatch)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(len(ref["metrics"])):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with replayed("steps", i):
                model, opt, met = step(model, opt, placed)
            if cuda:
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
            metrics.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
            state = ref["states"][i]
            if state is None:                   # the one-rank run kept only later steps
                continue
            got = dict(model.named_parameters())
            (errs[f"params_{i + 1}"], where[f"params_{i + 1}"], errs[f"near_{i + 1}"],
             counts[f"near_{i + 1}"]) = _worst(got, state["params"], specs, mesh,
                                               state.get("near"))
            for k in ("m", "v"):
                errs[f"{k}_{i + 1}"], where[f"{k}_{i + 1}"], _, _ = _worst(
                    opt[k], state[k], mspecs, mesh)
        if gather_moments:
            worst = 0.0
            for k in ("m", "v"):
                for n, t in opt[k].items():
                    for dim, entry in enumerate(mspecs[n]):
                        if shd._axes(entry):
                            t = col.gather(t, shd._axes(entry), dim)
                    worst = max(worst, rel_err(t, ref["states"][-1][k][n]))
            errs["moments_gathered"] = worst
    want_metrics = ref["metrics"]
    for i, (g, w) in enumerate(zip(metrics, want_metrics, strict=True)):
        for k in ("loss", "grad_norm"):
            errs[f"{k}_{i + 1}"] = abs(g[k] - w[k]) / max(1.0, abs(w[k]))
    return {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev), "errs": errs,
            "where": where, "near_counts": counts, "metrics": metrics,
            "want_metrics": want_metrics, "held": held,
            "rule": rule, "step_s": walls, "ref_step_s": list(ref.get("step_s", [])),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "finite": all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                          for m in metrics)}


def trains(mesh, cases: list[tuple[str, dict, dict]]) -> list[dict]:
    """``train`` for each (arch, overrides, keywords) of ``cases`` in one
    launch."""
    return [train(mesh, arch, overrides=over, **kw) for arch, over, kw in cases]
