"""Measured stage execution: run model-zoo variants on one torch device and
time their serving step for real (port of ``repro/cluster/executor.py``).

Every latency the controller optimizes comes from the analytic
``(alpha, beta)`` perf model (``cluster/perf_model.py``), whose constants
describe a TPU v5e. ``StageExecutor`` measures the real curve: it builds an
architecture from the model zoo (``configs/`` via ``models/api.py``),
quantises its weights (``quantize_params``), and times its decode serving
step (``models/steps.make_serve_step``) per (arch × batch × quant) with
warm-up and min-of-k timing (``repro_torch.timing``).

What the cache holds. The reference caches one AOT-compiled executable per
key. Here a key's entry holds the step, its static inputs (built once: a
graph replays on fixed addresses) and, on a CUDA device, a
``torch.cuda.CUDAGraph`` captured from the step, so the timed latency is
the card's own work and not eager PyTorch's per-launch host cost (about a
thousand launches per step at these widths). The eager step is timed
beside it. Each replay runs the same step on the same inputs: the KV slot
write is indexed by a device tensor and rewrites one slot, and nothing in
the step reads back to the host. Graphs of one arch share a memory pool;
an entry's outputs are valid until another graph of that arch replays.

The kernels' ``launches`` counters count Python calls, so a replay adds
nothing to them: an entry records the launches of its captured step.
Flops come from ``torch.utils.flop_counter.FlopCounterMode`` over one eager
step, plus 4·B·H·C·D per decode-kernel launch, which the counter cannot
see (the kernel is called through ctypes; on the CPU the plain version's
products are counted by the counter itself). Bytes are counted by formula.
``cluster/calibration.py`` fits the measured ``latency(b)`` curves back
into per-variant ``(alpha, beta)``.
"""
from __future__ import annotations

import shutil
import subprocess
import time  # reprolint: ignore[RPL002] host-side clock around warm-up and capture, outside the step
from dataclasses import dataclass, field

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import api, steps
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.nn.linear import Embedding
from repro_torch.timing import time_fn

QUANT_BITS = {"int8": 8, "int4": 4}
CAPTURE_WARMUP = 2                    # eager steps on a side stream before capture


def quantize_params(model: torch.nn.Module, quant: str) -> torch.nn.Module:
    """The serving quantisation axis, executably, in place on ``model``:
    ``bf16`` casts every floating parameter to bfloat16; ``int8``/``int4``
    symmetric-fake-quantise each reference leaf to 2^bits levels with one
    max-abs scale and store it in bfloat16 (the measured backend has no
    integer matmul kernels, and the calibration records that truthfully).
    Norm gains and embeddings are included, as in the reference. Where the
    reference stacks a family's layers on a leading [L, ...] axis
    (``stacked_layers`` on the model: dense, audio), one leaf holds a
    parameter of every layer, so its layers share one scale here too."""
    if quant != "bf16" and quant not in QUANT_BITS:
        raise ValueError(f"unknown quant {quant!r}; one of bf16, "
                         f"{', '.join(QUANT_BITS)}")
    leaves: dict[str, list] = {}
    stacked = getattr(model, "stacked_layers", False)
    for name, p in model.named_parameters():
        if p.is_floating_point():
            if stacked and name.startswith("layers."):
                name = "layers.*." + name.split(".", 2)[2]
            leaves.setdefault(name, []).append(p)
    with torch.no_grad():
        for params in leaves.values():
            if quant == "bf16":
                for p in params:
                    p.data = p.data.to(torch.bfloat16)
                continue
            qmax = float(2 ** (QUANT_BITS[quant] - 1) - 1)
            scale = torch.max(torch.stack([torch.max(torch.abs(p)) for p in params])) / qmax
            scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
            for p in params:
                levels = torch.clamp(torch.round(p.data / scale), -qmax - 1, qmax)
                p.data = (levels * scale).to(torch.bfloat16)
    return model


@dataclass(frozen=True)
class ExecKey:
    """Identity of one captured stage step."""
    arch: str
    batch: int
    quant: str
    device: str
    seq_len: int


@dataclass
class _Entry:
    cfg: ArchConfig
    model: torch.nn.Module
    step: object                  # (model, batch, cache) -> (logits, cache)
    batch: dict                   # static inputs: replays read these addresses
    cache: dict
    compile_s: float              # eager warm-up + capture (0.0 without a graph)
    graph: torch.cuda.CUDAGraph | None = None
    out: tuple | None = None      # the graph's static outputs
    launches: dict = field(default_factory=dict)   # kernel launches per captured step
    replays: int = 0
    cost: dict | None = None      # flops / bytes, computed lazily

    def eager(self):
        with torch.inference_mode():
            return self.step(self.model, self.batch, self.cache)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        return self.out


@dataclass
class ExecutableCache:
    """Captured-step cache with hit/miss accounting. ``lookups == hits +
    misses``; a repeated configuration never triggers a rebuild."""
    entries: dict = field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def get_or_build(self, key: ExecKey, build) -> tuple[_Entry, bool]:
        """-> (entry, was_hit). ``build()`` runs only on a miss."""
        entry = self.entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry, True
        self.misses += 1
        entry = build()
        self.entries[key] = entry
        return entry, False


@dataclass(frozen=True)
class StageTiming:
    """One measured point of a variant's latency curve."""
    arch: str
    batch: int
    quant: str
    backend: str              # "reference" always: attention takes the kernels on a
                              # CUDA tensor and the plain path on the CPU
    device_class: str
    latency_s: float          # min-of-k graph replay (eager step on the CPU)
    compile_s: float          # warm-up + capture; 0.0 on a cache hit
    cache_hit: bool
    flops: float              # one step: counted products + decode attention
    bytes: float              # one step: weights, cache read, slot/state written
    eager_latency_s: float | None = None   # min-of-k eager step
    launches: dict = field(default_factory=dict)   # kernel launches per captured step
    replays: int = 0          # graph replays this measurement made


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def step_bytes(model: torch.nn.Module, cache: dict, batch: int, logits) -> float:
    """Bytes one decode step must move, each read once and each write once:
    every parameter (only ``batch`` rows of an embedding table); of the
    self-attention KV (``k``/``v`` [L, B, C, kv, hd]) the valid slots read
    (``min(pos + 1, C)`` per row: the decode kernel skips masked tiles) and
    the new slot written; the whole recurrent state (``states``) read and
    written; whisper's cross-attention KV (``ck``/``cv``) read whole; and
    the logits written."""
    tables = [m.e for m in model.modules() if isinstance(m, Embedding)]
    ids = {id(e) for e in tables}
    total = sum(_nbytes(p) for p in model.parameters() if id(p) not in ids)
    total += sum(batch * e.shape[1] * e.element_size() for e in tables)
    for key, val in cache.items():
        if key == "pos":
            continue
        for t in _tensors(val):
            if key in ("k", "v"):
                slot = _nbytes(t) // (t.shape[1] * t.shape[2])     # one row's slot
                valid = int(torch.clamp(cache["pos"] + 1, max=t.shape[2]).sum())
                total += (valid + t.shape[1]) * slot
            else:
                total += _nbytes(t) * (2 if key == "states" else 1)
    return float(total + _nbytes(logits))


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it ("not measured"
    without nvidia-smi)."""
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class StageExecutor:
    """Executes model-zoo serving steps on one torch device and measures
    them. ``device`` defaults to ``"cuda"``; ``smoke=True`` runs each
    architecture's reduced same-family variant (``ArchConfig.smoke``), as
    the CPU tests do. ``cache`` may be shared between executors."""

    def __init__(self, device="cuda", *, seq_len: int = 32, smoke: bool = False,
                 seed: int = 0, cache: ExecutableCache | None = None):
        self.device = resolve_device(device)
        self.seq_len = seq_len
        self.smoke = smoke
        self.seed = seed
        self.cache = cache if cache is not None else ExecutableCache()
        self._params: dict = {}       # (arch, quant) -> quantised model
        self._pools: dict = {}        # arch -> graph memory pool

    # ----------------------------------------------------------- identity --

    @property
    def device_class(self) -> str:
        """Label for calibration tables: device type + device count (e.g.
        ``cuda1``) — map it onto ``NodeSpec.device_class`` names via
        ``calibration.apply_to_cluster``."""
        return f"{self.device.type}1"

    def device_meta(self) -> dict:
        """The device's name (and a card's power limit) for a table's meta."""
        if self.device.type == "cuda":
            return {"device_name": torch.cuda.get_device_name(self.device),
                    "power_limit": power_limit()}
        return {"device_name": "cpu", "power_limit": "not measured"}

    def key_for(self, arch: str, batch: int, quant: str = "bf16") -> ExecKey:
        return ExecKey(arch=arch, batch=int(batch), quant=quant,
                       device=str(self.device), seq_len=self.seq_len)

    # ------------------------------------------------------------- builds --

    def arch_config(self, arch: str) -> ArchConfig:
        cfg = ARCHS[arch]
        return cfg.smoke() if self.smoke else cfg

    def params_for(self, arch: str, quant: str = "bf16"):
        """Init once and quantise (cached: the weights are batch-independent)."""
        pkey = (arch, quant)
        if pkey not in self._params:
            cfg = self.arch_config(arch)
            model = api.init_model(self.seed + len(self._params), cfg, device=self.device)
            self._params[pkey] = quantize_params(model, quant)
        return self._params[pkey]

    def _inputs(self, cfg: ArchConfig, shape: InputShape):
        """Concrete decode-step (batch, cache) on the device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed + 1) * 1_000_003 + shape.global_batch)
        tokens = torch.randint(0, cfg.vocab, (shape.global_batch, 1), generator=gen,
                               device=self.device, dtype=torch.int64)
        ctx = steps.cache_context(cfg, shape)
        cache = api.init_cache(cfg, shape.global_batch, max(ctx, 1), device=self.device)
        return {"tokens": tokens}, cache

    def _capture(self, entry: _Entry, arch: str):
        """Warm up on a side stream (cuBLAS workspaces, the kernels' plans
        and one-time attributes), then capture one step into a graph."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                entry.eager()
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = self._pools.setdefault(arch, torch.cuda.graph_pool_handle())
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph, pool=pool):
            out = entry.step(entry.model, entry.batch, entry.cache)
        after = ops.launch_counts()
        entry.graph, entry.out = graph, out
        entry.launches = {k: after[k] - before[k] for k in after}

    def compiled_step(self, arch: str, batch: int,
                      quant: str = "bf16") -> tuple[_Entry, bool]:
        """-> (entry, was_hit): the captured serving step for one
        configuration with its static inputs."""
        key = self.key_for(arch, batch, quant)

        def build() -> _Entry:
            cfg = self.arch_config(arch)
            shape = InputShape(name=f"serve_b{batch}", seq_len=self.seq_len,
                               global_batch=batch, kind="decode")
            model = self.params_for(arch, quant)
            batch_in, cache_in = self._inputs(cfg, shape)
            entry = _Entry(cfg=cfg, model=model, step=steps.make_serve_step(cfg, shape),
                           batch=batch_in, cache=cache_in, compile_s=0.0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                self._capture(entry, arch)
                torch.cuda.synchronize(self.device)
                entry.compile_s = time.perf_counter() - t0
            return entry

        return self.cache.get_or_build(key, build)

    # -------------------------------------------------------- measurement --

    def cost(self, entry: _Entry) -> dict:
        """Flops and bytes of one step (see the module docstring)."""
        if entry.cost is None:
            B = entry.batch["tokens"].shape[0]
            before = ops.launch_counts()["decode_attention"]
            with FlopCounterMode(display=False) as counter:
                logits, _ = entry.eager()
            calls = ops.launch_counts()["decode_attention"] - before
            flops = float(counter.get_total_flops())
            if calls:
                C = entry.cache["k"].shape[2]         # [L, B, C, kv, hd]
                flops += calls * 4.0 * B * entry.cfg.n_heads * C * entry.cfg.head_dim
            entry.cost = {"flops": flops,
                          "bytes": step_bytes(entry.model, entry.cache, B, logits)}
        return entry.cost

    def measure(self, arch: str, batch: int, quant: str = "bf16", *, reps: int = 5,
                warmup: int = 1) -> StageTiming:
        """Min-of-``reps`` measured step latency for one configuration: the
        graph replay on a CUDA device (the eager step beside it), the eager
        step on the CPU. Capture happens outside the timed region (cached);
        each timed pass synchronises the device inside the clock."""
        entry, was_hit = self.compiled_step(arch, batch, quant)
        replays0 = entry.replays
        eager = time_fn(entry.eager, reps=reps, warmup=warmup, device=self.device)
        latency = (time_fn(entry.replay, reps=reps, warmup=warmup, device=self.device)
                   if entry.graph is not None else eager)
        cost = self.cost(entry)
        return StageTiming(
            arch=arch, batch=int(batch), quant=quant, backend="reference",
            device_class=self.device_class, latency_s=latency.best,
            compile_s=0.0 if was_hit else entry.compile_s, cache_hit=was_hit,
            flops=cost["flops"], bytes=cost["bytes"], eager_latency_s=eager.best,
            launches=dict(entry.launches), replays=entry.replays - replays0)

    def measure_curve(self, arch: str, batches, quant: str = "bf16", *, reps: int = 5,
                      warmup: int = 1) -> list[StageTiming]:
        """The variant's measured ``latency(b)`` curve across ``batches`` —
        the calibration fit's input."""
        return [self.measure(arch, b, quant, reps=reps, warmup=warmup)
                for b in batches]
