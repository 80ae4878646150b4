"""Dry run: count every (architecture x input shape) on one H100, and run
the ones that fit; or count it per device on the production meshes (the
counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--measure 3] [--out D]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu --smoke --measure 1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--multi-pod] \
        [--collect experiments/results/h100/dryrun_meshes.json]

The reference lowers and compiles each step on a 16 x 16 TPU v5e pod of
placeholder devices and reads XLA's memory and cost analyses. Here each
step (bf16, ``ArchConfig.dtype``, as the reference's) is built and run on
fake tensors (``FakeTensorMode``: shapes and dtypes, no storage, no random
draw), on the card's (1, 1) mesh, and counted:

  * params, AdamW moments (train), cache and batch bytes per device through
    ``distributed.sharding``'s rules (on one card: whole);
  * flops, unfused aten bytes and the peak of live storage over the eager
    program (``launch/step_cost.py``; causal attention counted as the CUDA
    kernel computes it, 4·B·H·D per unmasked pair: on fake tensors the
    kernels' plain versions, which compute the whole S x S square, do not
    run), and the minimum bytes the step must move;
  * ``model_flops``: 6·N·D for train, 2·N·D for inference (the reference's
    ``model_flops``);
  * the roofline terms against the H100's own peaks (989 TFLOP/s bf16
    dense, 3.35 TB/s, 80 GB; NVIDIA's SXM data sheet). One card has no
    collective term, and the record says so.

``--both-meshes`` counts on 16 x 16 ("data", "model") and 2 x 16 x 16
("pod", "data", "model") H100s instead (``--multi-pod``: the latter
alone), the reference's production meshes. For every family's records
(``sharding.SHARDED_FAMILIES``), rank 0's sharded program runs on fake tensors
under a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``): every parameter, cache
and batch tensor is placed as the rules place it (``sharding.place``),
the prefill and the train step carry the sequence-parallel ``shard_h``,
the train step's AdamW moments are ZeRO-1 blocks (``sharding.zero_layout``,
the reference's ``opt_shardings``) and its layers are rematerialised as
the config says, and the counters above count per device, with the bytes
each collective moves, the backward's and the update's included
(``distributed.collectives.counting``). ``collective_s`` sums, over the
groups the program reduces in, their bytes over the bandwidth of the
slowest link the group spans (``LINKS``: ranks are numbered row-major with
"model" innermost, ``NODE`` cards to an HGX node). A recurrent family's
prefill and train step are counted at a few lengths and extrapolated in S,
at full depth (``seq_extrapolated_count``). The minimum bytes are the
rank's own: a decode reads its rows x slots of its cache block. A family
without a sharded program would keep the rules' resident bytes per device
and say why its collective term is missing (``RULES_ONLY``); none is left.

A record is ``OK`` when its counted peak fits a card's 80 GB,
``DOES_NOT_FIT`` (with the counted bytes) when it does not, or ``SKIP``
(the reference's ``SKIPS``). ``--measure K`` then runs up to K records that
fit, decode shapes first, on the device for real: random bf16 weights from
seed 0, one warm-up step, the min of ``REPS`` synchronised steps,
``torch.cuda.max_memory_allocated`` against the counted peak, and the share
of the bound. A decode cache holds its whole context (every slot valid), as
the reference's ``cache_specs``. ``--device cpu --smoke`` counts and runs
the reduced configs on the host (times are then host times; no peak is
measured). Records go to ``<out>/<arch>_<shape>_<mesh>.json``.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import time  # reprolint: ignore[RPL002] host clock around synchronised measured steps
from fractions import Fraction

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch import step_cost
from repro_torch.launch.mesh import AXES, POD_AXES, make_device_mesh, make_mesh
from repro_torch.models import api, steps
from repro_torch.models.config import INPUT_SHAPES, InputShape
from repro_torch.train import adamw_init

# --------------------------------------------------------- hw constants ----
PEAK_FLOPS = 989e12     # bf16 dense tensor cores, H100 SXM data sheet
HBM_BW = 3.35e12        # bytes/s, H100 SXM data sheet
HBM_BYTES = 80e9        # the card's memory, H100 SXM data sheet
DEVICE = "H100 SXM (1 card)"
REPS = 5                # synchronised steps of a measured record, after one warm-up
COUNT_WORKERS = 8       # counting processes at most (each holds its own torch)
PRODUCTION_MESHES = ("16x16", "2x16x16")     # the reference's, by name
NODE = 8                # cards of one HGX H100 node, joined by NVLink
# bytes/s a direction per card on the slowest link a group spans (data sheets)
LINKS = {"nvlink": ("NVLink 4 within an 8-card HGX H100 node, 450 GB/s a direction", 450e9),
         "ib": ("400 Gb/s InfiniBand NDR across nodes, one NIC a card: 50 GB/s", 50e9)}

SKIPS = {
    # enc-dec with 448 target positions has no 500k-decode regime (DESIGN.md)
    ("whisper-small", "long_500k"): "enc-dec: no 500k decode regime",
}


def model_flops(cfg, shape) -> float:
    """6·N_active·D for train, 2·N_active·D for inference FLOPs/step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * 1 * shape.global_batch           # decode: one token


def arch_config(arch: str, *, smoke: bool = False):
    """bf16, as the reference's dry run; ``use_flash`` routes attention
    through ``kernels.ops`` on the CPU and on fake tensors too, as a CUDA
    tensor always goes (it only picks the route off the card)."""
    cfg = ARCHS[arch].smoke() if smoke else ARCHS[arch]
    return cfg.replace(dtype="bfloat16", use_flash=True)


def build_step(cfg, shape, device, *, gen: torch.Generator | None = None):
    """-> (step, args, inputs): the step of ``shape.kind`` and its arguments
    on ``device`` (under ``FakeTensorMode`` a fake device). ``gen`` draws
    tokens and stub embeddings; without it they are zeros. A decode cache's
    context is consumed: ``pos`` puts every slot in the valid window."""
    model = api.init_model(0, cfg, device=device)
    batch = {}
    for k, spec in steps.batch_specs(cfg, shape).items():
        if gen is None:
            batch[k] = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        elif spec.dtype.is_floating_point:
            batch[k] = (torch.randn(spec.shape, generator=gen, device=device) * 0.02
                        ).to(spec.dtype)
        else:
            batch[k] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device=device,
                                     dtype=spec.dtype)
    if shape.kind == "train":
        opt = adamw_init(model)
        return steps.make_train_step(cfg), (model, opt, batch), (model, opt, batch)
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg), (model, batch), (model, batch)
    ctx = max(steps.cache_context(cfg, shape), 1)
    cache = api.init_cache(cfg, shape.global_batch, ctx, device=device)
    if "pos" in cache:
        cache["pos"].fill_(shape.seq_len - 1)
    return (steps.make_serve_step(cfg, shape), (model, batch, cache),
            (model, batch, cache))


def _min_bytes(cfg, shape, args, out, *, tokens: int | None = None) -> float:
    """What the step must move, each input read once, each output once, on
    the device that runs it: a decode reads the embedding rows of its batch
    rows and every slot of its cache block (the context is consumed, so
    every slot is valid), which on a mesh is the rank's rows and slots; a
    prefill reads at most ``tokens`` rows of each embedding table (default
    the whole batch's tokens)."""
    if shape.kind == "decode":
        model, batch, cache = args
        logits = out[0]
        kv = cache.get("k")
        valid = None if kv is None else kv.shape[1] * kv.shape[2]    # [.., B, C, ..]
        return step_cost.step_bytes(model, cache, batch["tokens"].shape[0], logits,
                                    valid=valid)
    if shape.kind == "prefill":
        model, batch = args
        if tokens is None:
            tokens = shape.global_batch * shape.seq_len
        return step_cost.io_bytes([model, batch], list(out), tokens=tokens)
    model, opt, batch = args
    moments = [opt["m"], opt["v"]]
    return step_cost.io_bytes([model, batch] + moments, [model] + moments)


_COUNTED = ("flops", "attention_flops", "aten_bytes", "peak_bytes", "min_bytes")


def layer_units(cfg) -> tuple[int, int]:
    """(layers per repeating unit, units): the xLSTM's sLSTM period, zamba's
    group of mamba layers under one shared block, llama4's interleave block,
    else one layer."""
    if cfg.family == "ssm":
        period = cfg.slstm_every or 1
    elif cfg.family == "hybrid":
        period = cfg.attn_every
    else:
        period = cfg.moe_every if cfg.n_experts and cfg.moe_every > 1 else 1
    return period, cfg.n_layers // period


def count_points(cfg, shape) -> tuple[tuple, tuple]:
    """(unit counts, sequence lengths) a step is counted at. Every layer
    unit runs the same ops, so each counter is a + b·units: two unit counts
    give it (0 and 1 for the xLSTM, whose model runs with no layer; 1 and 2
    elsewhere). A recurrent family outside decode loops over the sequence
    op by op, which is slow to count at full length, so it is counted at
    short lengths in the full length's regime: the xLSTM, affine in S (its
    mLSTM chunks past 256 tokens and its loss chunks past 512 are all
    alike), at two; zamba, whose shared attention is quadratic, at three
    (the parabola through them)."""
    units = (0, 1) if cfg.family == "ssm" else (1, 2)
    if shape.kind == "decode" or cfg.family not in ("ssm", "hybrid"):
        return units, (shape.seq_len,)
    if cfg.family == "ssm":
        return units, ((512, 768) if shape.kind == "prefill" else (1024, 1536))
    return units, (1024, 2048, 3072)


def _count_once(cfg, shape) -> dict:
    t0 = time.perf_counter()
    with FakeTensorMode():
        step, args, inputs = build_step(cfg, shape, "cpu")
        out, cost = step_cost.measure(step, *args, inputs=inputs)
        counted = {"flops": cost.flops, "attention_flops": cost.attention_flops,
                   "aten_bytes": cost.aten_bytes, "peak_bytes": cost.peak_bytes,
                   "min_bytes": _min_bytes(cfg, shape, args, out), **cost.calls}
    return {**counted, "count_s": time.perf_counter() - t0}


def mesh_spec(name: str) -> tuple[tuple[int, ...], bool]:
    """A mesh's name ("16x16", "2x16x16") -> (shape, multi_pod): three
    sizes are ("pod", "data", "model")."""
    shape = tuple(int(x) for x in name.split("x"))
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh {name!r}: two or three sizes")
    return shape, len(shape) == 3


def _fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return dist


def _count_once_mesh(cfg, shape, mesh_name: str, seq_len: int | None = None) -> dict:
    """``_count_once`` of rank 0's sharded program on the ``mesh_name``
    mesh, with the collective bytes it moves per device, by group
    (``coll_bytes:<axes>``). A prefill's embedding rows read are capped at
    the rank's tokens of the record's length ``seq_len`` (default
    ``shape.seq_len``), so that a count at a shorter length, extrapolated in
    S, reads what the record's step reads."""
    t0 = time.perf_counter()
    mesh_shape, multi_pod = mesh_spec(mesh_name)
    dist = _fake_world(int(torch.tensor(mesh_shape).prod()))
    try:
        mesh = make_device_mesh(mesh_shape, device="cpu")
        with FakeTensorMode():
            step, args, _ = build_step(cfg, shape, "cpu")
            model, cache, batch = shd.place(
                args[0], mesh, cfg=cfg, kind=shape.kind, multi_pod=multi_pod,
                cache=args[2] if shape.kind == "decode" else None,
                batch=args[2] if shape.kind == "train" else args[1])
            shard_h = shd.residual_constraint(cfg, shape, mesh, multi_pod=multi_pod)
            if shape.kind == "train":
                step = steps.make_train_step(cfg, shard_h=shard_h)
                args = (model, adamw_init(model, zero=shd.zero_layout(cfg, mesh)), batch)
            elif shape.kind == "prefill":
                step = steps.make_prefill_step(cfg, shard_h=shard_h)
                args = (model, batch)
            else:
                args = (model, batch, cache)
            axes = shd.program_axes(cfg, shape, mesh, multi_pod=multi_pod)
            with col.use_mesh(mesh, **axes), col.counting() as moved:
                out, cost = step_cost.measure(step, *args)
            tokens = batch["tokens"].shape[0] * steps.text_len(cfg, seq_len or shape.seq_len)
            counted = {"flops": cost.flops, "attention_flops": cost.attention_flops,
                       "aten_bytes": cost.aten_bytes, "peak_bytes": cost.peak_bytes,
                       "min_bytes": _min_bytes(cfg, shape, args, out, tokens=tokens),
                       **cost.calls,
                       **{"coll_bytes:" + ",".join(g): b for g, b in moved.by_group.items()}}
    finally:
        dist.destroy_process_group()
    return {**counted, "count_s": time.perf_counter() - t0}


def link_of(mesh_name: str, axes) -> str:
    """The slowest link (a ``LINKS`` key) the group over ``axes`` spans:
    NVLink when its ranks share one node, InfiniBand otherwise."""
    shape, _ = mesh_spec(mesh_name)
    names = POD_AXES if len(shape) == 3 else AXES
    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    members = ranks[tuple(slice(None) if a in axes else 0 for a in names)]
    return "nvlink" if len(set((members // NODE).flatten().tolist())) == 1 else "ib"


def _lagrange(xs, ys, x) -> Fraction:
    """The polynomial through (xs, ys), of degree len(xs) - 1, at x."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys, strict=True)):
        term = Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def count_steps(cfg, shape) -> list[tuple]:
    """The (config, shape) steps ``extrapolated_count`` counts: both unit
    counts at each sequence length of ``count_points``, in that order."""
    period, _ = layer_units(cfg)
    units, seqs = count_points(cfg, shape)
    return [(cfg.replace(n_layers=u * period),
             InputShape(shape.name, S, shape.global_batch, shape.kind))
            for S in seqs for u in units]


def extrapolated_count(cfg, shape, once=_count_once) -> tuple[dict, dict]:
    """The counters of ``cfg``'s step at ``shape`` from the smaller steps of
    ``count_steps`` (each counted by ``once``), exactly for flops, calls and
    the minimum and aten bytes; the peak is exact where it grows by the same
    bytes per unit and along S. -> (counters, how they were counted)."""
    period, units = layer_units(cfg)
    (u0, u1), seqs = count_points(cfg, shape)
    counted = [once(*step) for step in count_steps(cfg, shape)]
    keys = _COUNTED + ("flash_attention", "decode_attention")
    a, b = {k: [] for k in keys}, {k: [] for k in keys}
    for f0, f1 in zip(counted[::2], counted[1::2], strict=True):
        for k in keys:
            slope = (Fraction(f1[k]) - Fraction(f0[k])) / (u1 - u0)
            b[k].append(slope)
            a[k].append(Fraction(f0[k]) - u0 * slope)
    out = {k: float(_lagrange(seqs, a[k], shape.seq_len)
                    + units * _lagrange(seqs, b[k], shape.seq_len)) for k in keys}
    out["calls"] = {k: int(out.pop(k)) for k in ("flash_attention", "decode_attention")}
    out["count_s"] = sum(f["count_s"] for f in counted)
    return out, {"units": [u0, u1], "of": units, "layers_per_unit": period,
                 "seq_points": list(seqs)}


def _direct(cfg, direct: bool) -> bool:
    return direct or bool(cfg.n_layers % layer_units(cfg)[0])


def mesh_seq_points(cfg, shape) -> tuple | None:
    """The sequence lengths a mesh record is counted at, at full depth, and
    extrapolated from (``seq_extrapolated_count``): a recurrent family
    outside decode (``count_points``), whose sLSTM and chunk loops would
    unroll op by op over the whole sequence; None (counted once, whole)
    otherwise."""
    if shape.kind == "decode" or cfg.family not in ("ssm", "hybrid"):
        return None
    return count_points(cfg, shape)[1]


def seq_extrapolated_count(cfg, shape, once, seqs=None) -> tuple[dict, dict]:
    """The counters of ``cfg``'s step at ``shape`` from the same step at the
    full depth at each of ``seqs`` (default ``mesh_seq_points``; each
    counted by ``once``): the polynomial in S through them, of every
    counter, the collective bytes by group included. -> (counters, how
    they were counted)."""
    seqs = tuple(seqs or mesh_seq_points(cfg, shape))
    counted = [once(cfg, InputShape(shape.name, S, shape.global_batch, shape.kind),
                    seq_len=shape.seq_len) for S in seqs]
    keys = [k for k in counted[0] if k != "count_s"]
    out = {k: float(_lagrange(seqs, [Fraction(c[k]) for c in counted], shape.seq_len))
           for k in keys}
    out["count_s"] = sum(c["count_s"] for c in counted)
    return out, {"depth": "full", "seq_points": list(seqs)}


def sharded_program(cfg, shape) -> str | None:
    """None when a mesh record runs the sharded program, else why not."""
    if cfg.family not in shd.SHARDED_FAMILIES:
        return f"not yet: {cfg.family} sharded program not ported"
    return None


def steps_of(arch: str, shape_name: str, *, smoke: bool = False,
             mesh: str = "1x1") -> list[tuple]:
    """The steps ``count`` counts for one record. On the card's (1, 1) mesh
    each is (config, shape). On a mesh each is (config, shape, the mesh's
    name, the record's length), at full depth: the whole step once, or at a
    few shorter lengths, each reading the record's embedding rows
    (``_count_once_mesh``); a cut depth would change what the rules and
    ``decode_step`` read off the parameter count (the 100B+ expert split)."""
    if (arch, shape_name) in SKIPS:
        return []
    cfg, shape = arch_config(arch, smoke=smoke), INPUT_SHAPES[shape_name]
    if mesh != "1x1" and sharded_program(cfg, shape):
        return []
    if mesh != "1x1":
        seqs = mesh_seq_points(cfg, shape)
        if seqs is None:
            return [(cfg, shape, mesh, shape.seq_len)]
        return [(cfg, InputShape(shape.name, S, shape.global_batch, shape.kind), mesh,
                 shape.seq_len) for S in seqs]
    return [(cfg, shape)] if _direct(cfg, False) else count_steps(cfg, shape)


def resident_bytes(cfg, shape, mesh_name: str = "1x1") -> dict:
    """Params, batch, AdamW moments (train) and cache (decode) bytes per
    device by the rules on the named mesh."""
    mesh_shape, multi_pod = mesh_spec(mesh_name)
    mesh = make_mesh(mesh_shape, POD_AXES if multi_pod else AXES, "meta")
    params = shd.abstract_params(cfg)
    batch = steps.batch_specs(cfg, shape)                # meta tensors
    resident = {
        "params": shd.tree_shard_bytes(
            params, shd.param_shardings(cfg, mesh, multi_pod=multi_pod, kind=shape.kind,
                                        params=params), mesh),
        "batch": shd.tree_shard_bytes(batch, shd.batch_shardings(
            cfg, shape, mesh, multi_pod=multi_pod), mesh)}
    if shape.kind == "train":
        # the two AdamW moments, float32 (``train.adamw_init``)
        zero = shd.opt_shardings(cfg, mesh, multi_pod=multi_pod, params=params)
        resident["opt"] = 2 * sum(
            shd.shard_bytes(torch.empty(p.shape, dtype=torch.float32, device="meta"),
                            zero[n], mesh) for n, p in params.items())
    if shape.kind == "decode":
        cache = shd.abstract_cache(cfg, shape)
        resident["cache"] = shd.tree_shard_bytes(
            cache, shd.cache_shardings(cfg, shape, mesh, multi_pod=multi_pod, cache=cache),
            mesh)
    return {**resident, "total": sum(resident.values())}


def collective_term(counted: dict, mesh_name: str) -> tuple[float, dict]:
    """(collective_s, per group: bytes per device, link, bandwidth) from a
    mesh count's ``coll_bytes:<axes>`` counters."""
    groups, total = {}, 0.0
    for key in [k for k in counted if k.startswith("coll_bytes:")]:
        axes = tuple(key.split(":", 1)[1].split(","))
        link = link_of(mesh_name, axes)
        nbytes = counted.pop(key)
        groups[",".join(axes)] = {"bytes_per_device": nbytes, "link": LINKS[link][0],
                                  "bytes_per_s": LINKS[link][1]}
        total += nbytes / LINKS[link][1]
    return total, groups


def count(arch: str, shape_name: str, *, smoke: bool = False, direct: bool = False,
          once=None, mesh: str = "1x1") -> dict:
    """The counted record of one (arch, shape) on the named mesh (the
    card's (1, 1) by default); ``direct`` (or a depth that is no whole
    number of layer units, as the xLSTM's smoke config) counts the whole
    step once instead of extrapolating. A mesh record is counted at full
    depth: whole, or, for a recurrent family outside decode, at a few
    sequence lengths and extrapolated in S (``seq_extrapolated_count``). ``once`` counts one step
    (``count_all`` hands in the steps its workers counted); ``count_s``
    sums the seconds its steps took."""
    shape = INPUT_SHAPES[shape_name]
    n_cards = int(torch.tensor(mesh_spec(mesh)[0]).prod())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "device": DEVICE if mesh == "1x1" else
           f"H100 SXM x {n_cards}, HGX nodes of {NODE}", "smoke": smoke}
    if (arch, shape_name) in SKIPS:
        return {**rec, "status": "SKIP", "reason": SKIPS[(arch, shape_name)]}
    cfg = arch_config(arch, smoke=smoke)
    resident = resident_bytes(cfg, shape, mesh)
    if mesh != "1x1" and sharded_program(cfg, shape):
        why = sharded_program(cfg, shape)
        return {**rec, "status": "RULES_ONLY", "reason": why, "resident_bytes": resident,
                "roofline": {"collective_s": None, "collective": why}}
    if once is None:
        once = _count_once if mesh == "1x1" else functools.partial(_count_once_mesh,
                                                                   mesh_name=mesh)
    if mesh != "1x1" and not direct and mesh_seq_points(cfg, shape):
        counted, how = seq_extrapolated_count(cfg, shape, once)
        counted["calls"] = {k: int(counted.pop(k)) for k in ("flash_attention",
                                                              "decode_attention")}
    elif _direct(cfg, direct or mesh != "1x1"):
        counted, how = dict(once(cfg, shape)), {"direct": True}
        counted["calls"] = {k: counted.pop(k) for k in ("flash_attention",
                                                         "decode_attention")}
    else:
        counted, how = extrapolated_count(cfg, shape, once)
    count_s = counted.pop("count_s")
    mf = model_flops(cfg, shape) / n_cards
    terms = {"compute_s": counted["flops"] / PEAK_FLOPS,
             "memory_s": counted["min_bytes"] / HBM_BW}
    coll = {"collective_s": None, "collective": "none: one card, no collective"}
    if mesh != "1x1":
        coll_s, groups = collective_term(counted, mesh)
        terms["collective_s"] = coll_s
        coll = {"collective": {"counted_by": "distributed.collectives.counting: ring "
                                             "all_reduce, 2(g-1)/g x bytes per device, "
                                             "forward and backward; a gather is the "
                                             "all_reduce the program issues, of the "
                                             "whole zero-filled buffer",
                               "groups": groups}}
    fits = counted["peak_bytes"] <= HBM_BYTES
    return {
        **rec,
        "status": "OK" if fits else "DOES_NOT_FIT",
        "count_s": count_s,
        "counted_by": how,
        "resident_bytes": resident,
        "peak_bytes": counted["peak_bytes"],
        "hbm_bytes": HBM_BYTES,
        "flops_per_device": counted["flops"],
        "attention_flops": counted["attention_flops"],
        "attention_calls": counted["calls"],
        "min_bytes_per_device": counted["min_bytes"],
        "aten_bytes_per_device": counted["aten_bytes"],
        "roofline": {**terms, **coll,
                     "bound_s": max(terms.values()),
                     "dominant": max(terms, key=terms.get)},
        "model_flops": mf,
        "useful_flops_ratio": mf / counted["flops"] if counted["flops"] else 0.0,
    }


def measure(rec: dict, *, device="cuda") -> dict:
    """Run the record's step for real on ``device``: ms (min of ``REPS``
    synchronised steps after one warm-up), the peak of the memory it
    allocates (its inputs and the step's; not what the caller already held)
    against the counted peak on CUDA, and the share of the bound."""
    dev = resolve_device(device)
    cfg = arch_config(rec["arch"], smoke=rec["smoke"])
    shape = INPUT_SHAPES[rec["shape"]]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)     # what the caller still holds
    with torch.inference_mode(shape.kind != "train"):
        step, args, _ = build_step(cfg, shape, dev, gen=gen)
        if cuda:            # the step's peak: its inputs and what it allocates
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(1 + REPS):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = step(*args)
            if cuda:
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            del out
    ms = min(times[1:]) * 1e3
    m = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu (host time)",
         "ms": ms, "first_step_ms": times[0] * 1e3, "reps": REPS}
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - base
        m.update(peak_bytes=peak, peak_over_counted=peak / rec["peak_bytes"],
                 share_of_bound=rec["roofline"]["bound_s"] * 1e3 / ms)
    else:
        m.update(peak_bytes="not measured", share_of_bound="not measured")
    del args, step
    return m


def pick(records: list[dict], k: int) -> list[dict]:
    """Up to ``k`` records of the card's (1, 1) mesh that fit, decode
    shapes first."""
    ok = [r for r in records if r["status"] == "OK" and r["mesh"] == "1x1"]
    ok.sort(key=lambda r: INPUT_SHAPES[r["shape"]].kind != "decode")
    return ok[:k]


def _count_worker(step) -> dict:
    torch.set_num_threads(1)
    if len(step) == 4:
        return _count_once_mesh(*step)
    return _count_once(*step)


def count_all(archs, shapes, *, smoke: bool = False, workers: int | None = None,
              log=print, meshes=("1x1",)) -> list[dict]:
    """``count`` of every (arch, shape, mesh), in the order given. Every
    step it counts is a job of its own, and off the smoke configs the jobs
    go to ``workers`` spawned processes (by default one per core, at most
    COUNT_WORKERS), the longest first: the xLSTM's train step takes minutes."""
    jobs = [(a, s, m) for m in meshes for a in archs for s in shapes]
    if workers is None:
        workers = 1 if smoke else min(COUNT_WORKERS, os.cpu_count() or 1)
    once = {m: None for m in meshes}
    if workers > 1:
        steps = list(dict.fromkeys(st for a, s, m in jobs
                                   for st in steps_of(a, s, smoke=smoke, mesh=m)))
        steps.sort(key=lambda st: (st[0].family not in ("ssm", "hybrid")
                                   or st[1].kind == "decode", -st[1].seq_len))
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            done = dict(zip(steps, pool.map(_count_worker, steps, chunksize=1), strict=True))
        for m in meshes:
            once[m] = functools.partial(_done, done, mesh=None if m == "1x1" else m)
    records = [count(a, s, smoke=smoke, once=once[m], mesh=m) for a, s, m in jobs]
    for rec in records:
        if rec["status"] in ("SKIP", "RULES_ONLY"):
            log(f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:8s} {rec['status']} "
                f"({rec['reason']})")
            continue
        r = rec["roofline"]
        coll = ("" if r.get("collective_s") is None
                else f" coll={r['collective_s'] * 1e3:9.2f}ms")
        log(f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:8s} {rec['status']:12s} peak "
            f"{rec['peak_bytes'] / 1e9:9.2f} GB resident "
            f"{rec['resident_bytes']['total'] / 1e9:9.2f} GB "
            f"{rec['flops_per_device'] / 1e12:10.2f} TFLOP "
            f"comp={r['compute_s'] * 1e3:9.2f}ms mem={r['memory_s'] * 1e3:9.2f}ms{coll} "
            f"-> {r['dominant']} useful={rec['useful_flops_ratio']:.2f} "
            f"(counted in {rec['count_s']:.1f}s)")
    return records


def _done(done: dict, cfg, shape, mesh: str | None = None, seq_len: int | None = None
          ) -> dict:
    return done[(cfg, shape) if mesh is None else (cfg, shape, mesh,
                                                   seq_len or shape.seq_len)]


def write(records: list[dict], out: str):
    os.makedirs(out, exist_ok=True)
    for rec in records:
        name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
        with open(os.path.join(out, name), "w") as f:
            json.dump(rec, f, indent=1)


def collect(records: list[dict], path: str, command: str):
    """Every record in one JSON file, sorted by (mesh, arch, shape), with
    the command, the host's cores and the card beside them (``nvidia-smi``'s
    name and power limit, "not measured" without it)."""
    import shutil
    import subprocess
    card = "not measured"
    if shutil.which("nvidia-smi"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"command": command,
           "host": f"{os.cpu_count()} host cores, counted on fake tensors",
           "card": card,
           "records": sorted(records, key=lambda r: (r["mesh"], r["arch"], r["shape"]))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def run(archs, shapes, *, smoke: bool = False, measure_k: int = 0, device="cuda",
        out: str | None = None, log=print, meshes=("1x1",)) -> list[dict]:
    records = count_all(archs, shapes, smoke=smoke, log=log, meshes=meshes)
    for rec in pick(records, measure_k):
        rec["measured"] = measure(rec, device=device)
        log(f"measured {rec['arch']} {rec['shape']}: {json.dumps(rec['measured'])}")
    if out:
        write(records, out)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description="Count (and run what fits) every arch x "
                                             "input shape on one H100")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs (CPU rehearsal)")
    ap.add_argument("--measure", type=int, default=3,
                    help="run up to this many records that fit on the device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/dryrun")
    ap.add_argument("--multi-pod", action="store_true",
                    help="count per device on the 2 x 16 x 16 mesh instead of one card")
    ap.add_argument("--both-meshes", action="store_true",
                    help="count per device on 16 x 16 and 2 x 16 x 16 instead of one card")
    ap.add_argument("--collect", default=None,
                    help="also write every record into this one JSON file")
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.all or args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = (PRODUCTION_MESHES if args.both_meshes else
              ("2x16x16",) if args.multi_pod else ("1x1",))
    records = run(archs, shapes, smoke=args.smoke,
                  measure_k=args.measure if meshes == ("1x1",) else 0,
                  device=args.device, out=args.out, meshes=meshes)
    if args.collect:
        import sys
        collect(records, args.collect, " ".join(
            ["python -m repro_torch.launch.dryrun"] + list(sys.argv[1:] if argv is None
                                                           else argv)))
    print("dry-run complete")


if __name__ == "__main__":
    main()
