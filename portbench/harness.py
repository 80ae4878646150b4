"""One run of one cell: set-up, the measured window, the checks, the metrics.

Set-up builds one ``StageServer`` a stage with every variant at its published
widths in the configuration's dtype, copies in the benchmark's weights
(``weights``), builds the attention kernels into the checkout's
``build/kernels`` (or finds them there) and serves one short segment of the
cell's own traffic, so that every shape the window uses has run once.

The window serves the mix's segment back to back through
``repro_torch.api.Session.serve()``: each serve is a fresh env over the same
live stages, with the same arrivals (``traffic.Arrivals``), and the window
closes at the end of the first serve that ends after ``--seconds``. It is
whole segments, so the work it holds is fixed, and a rate over it does not
jump with the last stage's completions, which come 32 at a time. A segment
that takes longer than ``--seconds`` makes a window of one segment; shorter
segments make a window shorter than twice ``--seconds``. A wrapper around each
stage's ``execute`` times each batch on the host clock (``execute`` ends in a
copy of the argmax to the host, so a batch's wall is its device time and its
host launches) and records its inputs and outputs. With ``trace`` a
``torch.profiler`` slice covers a few seconds from 40% of ``--seconds``; the
host-clock figures of a traced run come from the rest of its window.

After the window the peak is read, the program's state is freed and the
checks run: the accounting of requests against the traffic generator, and
the plain reference over a sample, drawn from the seed, of the rows of every
variant that ran (``reference``, each architecture through its reference
module): for each, the widest gap by which a served token's reference logit
lies below the reference's best and, where the configuration gives it a
limit (``trim_limits``), the mean of the gaps up to their 95th percentile.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import reference, spec, traffic as gen, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
ROWS_PER_VARIANT = 4  # reference rows a (stage, variant): 4 x 448 served tokens
TRACE_START, TRACE_LEN = 0.4, 4.0  # the profiled slice: from 0.4 of --seconds, 4 s at most


@dataclass
class Batch:
    segment: int
    stage: int
    variant: int
    tokens: np.ndarray
    out: np.ndarray
    t0: float
    t1: float
    traced: bool = False

    @property
    def size(self) -> int:
        return int(self.tokens.shape[0])


@dataclass
class Recorder:
    """The wrapper around each stage's ``execute``, and the profiled slice."""

    names: list
    segment: int = -1
    recording: bool = False
    batches: list = field(default_factory=list)
    trace_at: float = math.inf
    trace_until: float = math.inf
    prof: object = None
    tracing: bool = False
    span: dict = field(default_factory=dict)

    def wrap(self, stage: int, execute):
        def recorded(z, tokens):
            self._profile(time.perf_counter())
            z = int(z) % len(self.names[stage])
            t0 = time.perf_counter()
            if self.tracing:
                with torch.profiler.record_function(f"execute {self.names[stage][z]}"):
                    out = execute(z, tokens)
            else:
                out = execute(z, tokens)
            t1 = time.perf_counter()
            out = np.array(out, copy=True)  # its rows are what the requests keep
            if self.recording:
                self.batches.append(Batch(self.segment, stage, z, tokens, out, t0, t1,
                                          self.tracing))
            return out

        return recorded

    def _profile(self, now: float):
        if self.prof is None and now >= self.trace_at:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.span = {"start": time.perf_counter(), "start_ns": time.time_ns()}
            self.tracing = True
        elif self.tracing and now >= self.trace_until:
            self.stop_profile()

    def stop_profile(self):
        if self.tracing:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.span["stop_ns"] = time.time_ns()
            self.prof.stop()
            self.span["resumed"] = time.perf_counter()
            self.tracing = False


def process_age() -> float:
    """Seconds since this process started (``/proc``), for ``setup_s``."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """The program under test for one cell, built once; ``run`` serves one seed."""

    def __init__(self, workload: str, *, root: Path = spec.ROOT, device: str = "cuda",
                 bench: dict | None = None, log=None):
        self.root = Path(root)
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self.bench = bench or spec.load_benchmark(self.root)
        self.cell = spec.find_cell(self.bench, workload)
        self.config = spec.load_config(self.bench, self.cell["config"], self.root)
        self.traffic = spec.load_traffic(self.cell["traffic"], self.root)
        self.device = torch.device(device)
        self.segment_s = self.traffic["segment_s"]
        self.servers = None
        self.seed = None

    # ----------------------------------------------------------- set-up --

    def archs(self, stage: int) -> list[dict]:
        return [self.config["archs"][n] for n in self.config["stages"][stage]]

    def build(self, seed: int):
        """Stage servers with the benchmark's weights for ``seed``."""
        from repro_torch.configs import ARCHS
        from repro_torch.models.config import ArchConfig
        from repro_torch.serving.engine import StageServer

        if self.device.type == "cuda":
            from repro_torch.kernels import build

            t = time.perf_counter()
            build.build(build.KERNELS)
            self.log(f"set-up: kernels built or found in {time.perf_counter() - t:.3f} s")
        if self.servers is None:
            # on the card the file's sizes are the program's own, but for the cuts
            # it states (the CPU tests run cut-down copies)
            errors = spec.size_errors(self.config, ARCHS) if self.device.type == "cuda" else []
            if errors:
                raise RuntimeError("the configuration file differs from the program's "
                                   "published sizes: " + "; ".join(errors))
            self.servers = []
            for i, names in enumerate(self.config["stages"]):
                variants = [ArchConfig(**self.config["archs"][n]) for n in names]
                self.servers.append(StageServer(
                    f"stage{i}", variants, seq_len=self.traffic["seq_len"],
                    seed=weights.key(seed, i) % 2**31, device=self.device))
        for i, server in enumerate(self.servers):
            for z, arch in enumerate(self.archs(i)):
                if weights.supported(arch, self.config, self.root):
                    weights.fill(server.params[z], arch, seed, i, z, self.config, self.root)
        self.seed = seed

    def spec(self, horizon: int, seed: int):
        from repro_torch.api.specs import (ControllerSpec, ExperimentSpec, PipelineSpec,
                                           ScenarioSpec)

        t = self.traffic
        return ExperimentSpec(
            pipeline=PipelineSpec(name=self.config["name"],
                                  stages=tuple(tuple(s) for s in self.config["stages"]),
                                  quants=tuple(self.config["quants"])),
            scenario=ScenarioSpec(kind=t["kind"], rate=float(t["rate"]), seed=int(seed),
                                  horizon=int(horizon)),
            controller=ControllerSpec(name=t["controller"]),
            backend="runtime", real=True, seq_len=int(t["seq_len"]))

    def session(self, horizon: int, seed: int, recorder: Recorder, envs: list):
        """A session whose serves take the mix's ``Arrivals`` and the
        recorder's wrapped stages; each serve's env is kept in ``envs``."""
        from repro_torch.api.session import Session
        from repro_torch.cluster.env import RuntimeEnv

        sess = Session(self.spec(horizon, seed), device=self.device, dtype=self.config["dtype"])
        sess.servers = self.servers
        for i, server in enumerate(self.servers):
            server.execute = recorder.wrap(i, type(server).execute.__get__(server))

        def tracked():
            env = RuntimeEnv(sess.pipe, gen.Arrivals(self.traffic, seed), horizon=horizon,
                             executors=[s.execute for s in sess.stage_servers()],
                             seq_len=int(self.traffic["seq_len"]),
                             vocab=int(self.traffic["vocab"]),
                             forecaster=sess.build_forecaster())
            envs.append(env)
            return env

        sess.build_env = tracked
        return sess

    # ----------------------------------------------------------- window --

    def run(self, seed: int, seconds: float, trace: bool = False, *,
            keep: bool = False) -> dict:
        """Set-up (unless built for ``seed``), warm-up and the window; with
        ``keep`` the stage servers stay built for the next seed."""
        names = self.config["stages"]
        t = time.perf_counter()
        if self.seed != seed:
            self.build(seed)
        self._sync()
        self.log(f"set-up: servers and weights {time.perf_counter() - t:.3f} s "
                 f"(process age {process_age():.2f} s)")
        rec = Recorder(names)
        warm_envs: list = []
        t = time.perf_counter()
        self.session(int(self.traffic["warmup_s"]), seed, rec, warm_envs).serve()
        self._sync()
        self.log(f"set-up: warm-up serve {time.perf_counter() - t:.3f} s")
        if trace:  # the profiler's first start is slow: pay it in set-up
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts):
                torch.ones(1, device=self.device).add_(1)
        self._sync()
        setup_s = process_age()

        envs: list = []
        sess = self.session(self.segment_s, seed, rec, envs)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t_start = time.perf_counter()
        if trace:
            rec.trace_at = t_start + TRACE_START * seconds
            rec.trace_until = rec.trace_at + min(TRACE_LEN, 0.3 * seconds)
        rec.recording = True
        while True:
            rec.segment += 1
            sess.serve()
            if time.perf_counter() - t_start >= seconds:
                break
        t_end = time.perf_counter()
        rec.recording = False
        rec.stop_profile()
        self._sync()
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        found = forbidden_modules()
        if not keep:
            for server in self.servers:
                server.params = None
            self.servers, self.seed = None, None
            del sess
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        self.log(f"window: {t_end - t_start:.3f} s, {len(rec.batches)} batches, "
                 f"{rec.segment + 1} segments, peak {peak / 2**30:.3f} GiB")
        return {"setup_s": setup_s, "t_start": t_start, "t_end": t_end,
                "seconds": t_end - t_start, "rec": rec, "envs": envs, "peak": peak,
                "forbidden": found, "seed": seed}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- checks --

    def account(self, window: dict) -> dict:
        """Requests served in the window and the accounting checks."""
        rec = window["rec"]
        n_stages = len(self.config["stages"])
        by_base = {id(b.out): b for b in rec.batches}
        times, toks = gen.segment(self.traffic, window["seed"], self.segment_s)
        served, lost, wrong = [], 0, 0
        for env in window["envs"]:
            if env.submitted != len(times):
                wrong += 1
            for req in env.runtime.completed:
                hops = []
                for k, o in enumerate(req.stage_outputs):
                    b = by_base.get(id(o.base))
                    if b is None or b.stage != k:
                        hops = None
                        break
                    hops.append((b, (o.ctypes.data - b.out.ctypes.data) // b.out.strides[0]))
                if hops is None or len(hops) != n_stages:
                    wrong += 1
                    continue
                rid = req.rid
                b0, r0 = hops[0]
                ok = (0 <= rid < len(times) and abs(req.arrival - times[rid]) < 1e-9
                      and np.array_equal(b0.tokens[r0], toks[rid]))
                for (b, r), (nb, nr) in zip(hops, hops[1:], strict=False):
                    prev = np.zeros(self.traffic["seq_len"], np.int32)
                    src = b.out[r][: self.traffic["seq_len"]]
                    prev[: len(src)] = src
                    ok = ok and np.array_equal(nb.tokens[nr], prev)
                if not ok:
                    wrong += 1
                served.append(sum(b.t1 - b.t0 for b, _ in hops))
            lost += env.submitted - len(env.runtime.completed)
        for k in range(n_stages):  # every row of every batch is one served request
            wrong += abs(sum(b.size for b in rec.batches if b.stage == k) - len(served))
        return {"service_s": served, "lost": lost, "wrong": wrong}

    def sample(self, window: dict) -> dict:
        """Rows to hold against the reference, drawn from the seed: for each
        (stage, variant) that ran, ``ROWS_PER_VARIANT`` rows of its batches
        (the configuration's ``rows`` for an architecture it names), one of
        them the last row of its largest batch."""
        rng = np.random.default_rng(weights.key(window["seed"], 0x5A3))
        picks: dict = {}
        for b in window["rec"].batches:
            picks.setdefault((b.stage, b.variant), []).append(b)
        out = {}
        for (stage, z), batches in sorted(picks.items()):
            rows = self.config.get("rows", {}).get(self.archs(stage)[z]["name"],
                                                   ROWS_PER_VARIANT)
            largest = max(batches, key=lambda b: b.size)
            chosen = [(largest, largest.size - 1)]
            for _ in range(rows - 1):
                b = batches[int(rng.integers(len(batches)))]
                chosen.append((b, int(rng.integers(b.size))))
            out[stage, z] = chosen
        return out

    def judge(self, window: dict, *, control: bool = False):
        """(checks {name: (value, limit)}, accounting, details): the details
        give, for each architecture held, the gap statistics of the program
        and, with ``control``, those of the reference in fp8 put in its place,
        and ``control_checks``: the same checks with the control's tokens in
        the program's place."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        acc = self.account(window)
        checks = {"lost": (acc["lost"], 0), "misrouted": (acc["wrong"], 0)}
        low_checks = dict(checks)
        limits = self.config.get("limits", {})
        trim_limits = self.config.get("trim_limits", {})
        details, unchecked = {}, 0
        for (stage, z), chosen in self.sample(window).items():
            arch = self.archs(stage)[z]
            name = arch["name"]
            if not weights.supported(arch, self.config, self.root):
                unchecked += 1
                continue
            tokens = np.stack([b.tokens[r] for b, r in chosen])
            served = np.stack([b.out[r] for b, r in chosen])
            rows_ = [(b.size, r) for b, r in chosen]
            with torch.no_grad():
                ref = reference.logits(arch, window["seed"], stage, z, tokens, rows_, self.device,
                                       config=self.config, root=self.root)
                d = {"program": reference.gap_stats(ref, served)}
                if control:
                    low = reference.logits(arch, window["seed"], stage, z, tokens, rows_,
                                           self.device, quant="fp8", config=self.config,
                                           root=self.root)
                    d["control"] = reference.gap_stats(ref, low.argmax(-1).cpu().numpy())
                    del low
                del ref
            details[name] = d
            for side, out in (("program", checks), ("control", low_checks)):
                if side in d:
                    out[f"gap.{name}"] = (d[side]["widest"], limits.get(name))
                    if name in trim_limits:
                        out[f"gap_trim95.{name}"] = (d[side]["trim95"], trim_limits[name])
        checks["unchecked_variants"] = (unchecked, 0)
        if control:
            low_checks["unchecked_variants"] = (unchecked, 0)
            details["control_checks"] = low_checks
        return checks, acc, details


def passes(checks: dict) -> bool:
    """Every number within its limit; a number without a limit fails."""
    return all(lim is not None and v <= lim for v, lim in checks.values())


# ------------------------------------------------------------- metrics --


def context(cell: Cell, window: dict, acc: dict) -> dict:
    """What the metric readers read."""
    rec = window["rec"]
    t0, t1 = window["t_start"], window["t_end"]
    span = rec.span
    cut = (span["start"], span["resumed"]) if "resumed" in span else None
    batches = [b for b in rec.batches if b.t0 < t1]
    host = [b for b in batches if cut is None or not (b.t1 > cut[0] and b.t0 < cut[1])]
    ctx = {"cell": cell.cell, "config": cell.config, "root": cell.root, "archs": cell.archs,
           "window_s": window["seconds"], "batches": batches, "host_batches": host,
           "host_window_s": window["seconds"] - (cut[1] - cut[0] if cut else 0.0),
           "window": (t0, t1), "service_s": acc["service_s"],
           "dtype": cell.config["dtype"], "trace": None}
    if cut is not None:
        from portbench import trace as tr

        dev, ann = tr.events(rec.prof)
        # the slice on the profiler's own clock: it starts at a batch's start and
        # stops after a synchronise at a batch's end
        stamps = [t for s, e, _ in dev + ann for t in (s, e)]
        t0_ns, t1_ns = ((min(stamps), max(stamps)) if stamps
                        else (span["start_ns"], span["stop_ns"]))
        ctx["trace"] = {"device": dev, "annotations": ann, "t0_ns": t0_ns, "t1_ns": t1_ns,
                        "batches": [b for b in batches if b.traced]}
    return ctx


def report(cell: Cell, window: dict, trace: bool, checks: dict, acc: dict) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, the cell's
    metrics (end-to-end without ``trace``, per-layer with it), ``device``,
    the traced run's ``breakdown`` and, last, every number compared beside
    its limit."""
    ctx = context(cell, window, acc)
    ctx.update(setup_s=window["setup_s"], peak_bytes=window["peak"])
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(cell.bench, section, cell.cell["name"]):
        value = spec.load_reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(window["peak"])}
    out = {"correct": passes(checks), "attempted": len(acc["service_s"]) + acc["lost"],
           "failed": acc["lost"], "metrics": metrics, "device": device}
    tr = ctx["trace"]
    if trace and tr is not None:
        from portbench import trace as tmod

        device["busy_s"] = tmod.busy_ns(tr["device"], tr["t0_ns"], tr["t1_ns"]) / 1e9
        device["window_s"] = (tr["t1_ns"] - tr["t0_ns"]) / 1e9
        out["breakdown"] = {
            "device_ops": tmod.top_ops(tr["device"]),
            "idle_gaps": tmod.idle_gaps(tr["device"], tr["annotations"],
                                        tr["t0_ns"], tr["t1_ns"]),
        }
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
