"""GPU smoke test of the PyTorch/CUDA port: builds the Hopper kernels from
source, holds each against its plain PyTorch version on the card, then
drives the port's main paths at full width.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  env      nvidia-smi name and power limit, torch/CUDA versions, kernel build
           (ptxas registers and spills per instance), the HGMMA/HMMA counts
           of each flash instance from cuobjdump -sass (a bf16 instance
           without HGMMA fails)
  kernels  each kernel vs its plain version on the card (the reference test
           shapes, windows and non-causal flash in both dtypes, flash at S
           off the packed tiles' grid and D = 80, the decode kernel's ragged,
           no-valid-slot, split and tile-skipping masks and a cache of
           C = 1000, the slice's own shapes, flash at S = 2048; f32 at 2e-3,
           bf16 at 4e-2), with kernel, plain, library (SDPA) and
           roofline-bound times, achieved TFLOP/s and the share of the bound;
           timed flash rows also time one and two consumer warpgroups per
           CTA and name the tile plan; each decode case names its n_splits
  serve    a PipelineServer with one StageServer whose variants are
           llama3.2-1b and starcoder2-3b at full width: requests, a variant
           switch, more requests; launch counts; logits against the plain
           attention path
  decode   the launcher's decode loop, llama3.2-1b full width, batch 4,
           context 1024, 32 tokens; launch counts; teacher-forced forward
           (flash kernel) against the decode logits (decode kernel)
  runtime  Session.serve of the registered serve2 pipeline's stage 1
           (llama3.2-1b / starcoder2-3b at full width, live on the card) under
           the capacity controller, bursty arrivals, seed 3, 120 s of virtual
           time: every request served, both variants executed, the virtual-
           time results identical to the same spec with real=False, flash
           launches counted, the logits of the first batch of each variant
           and of the largest batch against the plain attention path
  opd      the registered opd controller on the same stage: Session.train on
           the card (4 episodes, 4 vectorized envs, expert every 2nd; episode
           wall times, the median synchronised ppo_minibatch_update, one
           vec_rollout of paper-4stage at 4 and 64 envs), the trained
           policy's log-probs, one PPO update and a greedy 4-env rollout held
           against the same computation on the CPU, then Session.serve with
           real=True under the trained policy (the runtime phase's checks,
           decision times d_t) and one epoch of the LSTM load predictor
           (predict_batch card vs CPU)
  calibrate
           measured stage execution: the StageExecutor grid of
           repro_torch.launch.calibrate (whisper-small, xlstm-125m, llama3.2-1b,
           starcoder2-3b at full width, bf16 and int8 weights, b = 1..32): per
           row the CUDA-graph replay and eager step latencies, the launches of
           one captured step, flops, bytes, bound and share; the fitted table
           and hit_rate_repeat >= 0.9; every captured step's logits against
           the eager step's and the plain attention path's, at the grid's one
           valid slot and again over random caches with several valid slots;
           then Session.serve of the registered serve2 pipeline, both stages
           live, with perf_source="calibrated" on that table (capacity
           controller, bursty, seed 3, 120 s): the runtime phase's checks on
           every stage, and the calibrated virtual p50/p99 and cost beside
           the analytic (TPU v5e) run's; then the same spec for 30 s under
           the random controller, which executes every variant of both stages
The kernels phase also holds whisper-small's g = 1 shapes (flash B4 S32
H12 Hkv12 D64, decode B4 H12 C32) in both dtypes and bf16 q over an f32
cache (llama3.2-1b's, starcoder2-3b's and whisper-small's decode steps),
all timed, the decode cases at 1, 9, 17 and 32 valid slots per row.
The last two lines are the kernel summary and the device line, as JSON.
Imports only torch, numpy and the port (never jax or the JAX package).
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
# Peak rate of f32-accurate products: 3xTF32 on the tensor cores (three TF32
# products at 495 TFLOP/s), above the 67 TFLOP/s of f32 FMA outside them.
PEAK_OPS = {torch.float32: 495e12 / 3,
            torch.bfloat16: 989e12}             # bf16 dense tensor cores
TOL = {torch.float32: 2e-3, torch.bfloat16: 4e-2}    # tests/test_kernels.py
# Full-width logits compared across two attention paths in f32 (TF32 off):
# the same tolerance as the reference's model-path test
# (tests/test_kernels.py::test_flash_matches_model_attention_path). The two
# paths differ only in summation order; f32 rounding over 16-30 layers stays
# orders of magnitude below it.
LOGIT_TOL = 5e-3
FA_SHAPES = [(1, 128, 4, 2, 64), (2, 256, 8, 8, 64), (1, 256, 6, 2, 128),
             (2, 128, 4, 1, 80)]                # (B, S, H, Hkv, D)
DEC_SHAPES = [(2, 8, 2, 64, 1024, 700), (1, 24, 8, 128, 2048, 2048),
              (4, 4, 4, 64, 512, 100), (2, 32, 8, 128, 1024, 1),
              (2, 16, 2, 80, 1024, 513), (1, 12, 1, 80, 300, 250),
              (1, 16, 1, 64, 256, 200), (1, 8, 8, 128, 32768, 20000)]  # (B, H, Hkv, D, C, nv)
# masks that exercise the decode kernel's split and tile skipping, at
# DEC_MASK_SHAPE and at a cache that is no multiple of the chunk (C = 1000)
DEC_MASKS = ("whole_split_false", "holes", "no_valid_slot", "last_split_only",
             "single_slot")
DEC_MASK_SHAPE = (2, 8, 2, 64, 1024)            # (B, H, Hkv, D, C)
DEC_RAGGED_SHAPE = (2, 8, 2, 64, 1000)
SLICE_FA = [(4, 32, 32, 8, 64), (4, 32, 24, 2, 128)]   # llama3.2-1b, starcoder2-3b
# the same two models at a prefill length, where the products bound the call
PREFILL_FA = [(1, 2048, 32, 8, 64), (1, 2048, 24, 2, 128)]
# flash cases off the packed tiles' grid: S no multiple of P (16, 5, 21, 4
# positions for g = 4, 12, 3, 16) nor of the kv tile, S below one tile and
# S = 1, D = 80 padded
RAGGED_FA = [(2, 33, 32, 8, 64), (1, 101, 24, 2, 128), (1, 100, 8, 2, 80),
             (1, 77, 6, 2, 128), (2, 65, 16, 1, 64), (3, 7, 8, 2, 64), (1, 1, 24, 2, 128)]
SLICE_DEC = (4, 32, 8, 64, 1024, 32)            # llama3.2-1b decode, last step
# further timed decode shapes: llama3.2-1b with a full cache, starcoder2-3b
# with 32 and with 1024 valid slots
TIMED_DEC = [(4, 32, 8, 64, 1024, 1024), (4, 24, 2, 128, 1024, 32),
             (4, 24, 2, 128, 1024, 1024)]
# valid slots per row of the calibrate grid's decode shapes (C = 32): the
# grid's own one slot, where softmax is 1 and q does not change the output,
# and several, where it does
GRID_NV = [1, 9, 17, 32]
# whisper-small's self-attention (MHA, g = 1): its serving prefill, and its
# decode step at the calibrate grid's cache
WHISPER_FA = (4, 32, 12, 12, 64)                # (B, S, H, Hkv, D)
WHISPER_DEC = (4, 12, 12, 64, 32, GRID_NV)      # (B, H, Hkv, D, C, nv)
# bf16 q over an f32 cache, what a decode step with bf16 weights hands over:
# llama3.2-1b's, starcoder2-3b's and whisper-small's steps in the calibrate grid
MIXED_DEC = [(4, 32, 8, 64, 32, GRID_NV), (4, 24, 2, 128, 32, GRID_NV), WHISPER_DEC]
SASS_OPS = ("HGMMA", "HMMA")
SOURCES = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:111"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:91")}


def instance_name(mangled: str) -> str:
    """flash_fwd_kernel<bf16, 128, 2, 128> from its mangled name (dtype,
    padded head_dim, consumer warpgroups, kv rows per tile); other names
    unchanged."""
    m = re.search(r"flash_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d)ELi(\d+)E", mangled)
    if not m:
        return mangled
    dtype = "bf16" if m.group(1).endswith("bfloat16") else "f32"
    return f"flash_fwd_kernel<{dtype}, {m.group(2)}, {m.group(3)}, {m.group(4)}>"


def sass_check():
    """Count the tensor-core instructions of each flash kernel instance in
    the built library: HGMMA is wgmma, HMMA mma.sync. A bf16 instance
    without HGMMA fails."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass: no cuobjdump in the toolkit: HGMMA/HMMA not checked", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = instance_name(line.split("Function : ")[1].strip())
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                counts[name][op] += len(re.findall(rf"\b{op}\.", line))
    bf16 = [n for n in counts if "<bf16" in n]
    for n, c in sorted(counts.items()):
        print(f"sass {n}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS), flush=True)
    check(bool(bf16), "no bf16 flash kernel instance in the built library")
    check(all(counts[n]["HGMMA"] > 0 for n in bf16), "a bf16 flash instance has no HGMMA")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


class Timer:
    """Device time of one call, from CUDA events, averaged over REPS calls.

    Before each call the 50 MB L2 is flushed, so every input is read from
    device memory as a cold caller would, and the device is held busy by a
    spin kernel while the host enqueues the call: the events then bracket
    the call's device work alone, not the host's launch latency."""

    REPS, WARMUP = 20, 3
    SPIN_CYCLES = 10_000_000        # ~5 ms: covers the host's enqueue of one call

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        for _ in range(self.WARMUP):
            fn()
        total = 0.0
        for _ in range(self.REPS):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.REPS


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def sdpa(q, k, v, **kw):
    """One PyTorch call computing the same attention, as a yardstick only.
    q [B,S,H,D], k/v [B,T,Hkv,D]."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)


def flash_case(timer, gen, shape, dtype, window=None, timed=False, causal=True):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, S, H, Hkv, D = shape
    q, k, v = (randn(gen, (B, S, h, D), dtype) for h in (H, Hkv, Hkv))
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    row = {"kernel": "flash_attention", "shape": list(shape), "dtype": str(dtype)[6:],
           "window": window, "causal": causal, "max_abs_err": err}
    ok = err < TOL[dtype] and out.shape == want.shape and out.dtype == want.dtype
    if timed:
        idx = torch.arange(S, device="cuda")
        keep = idx[None, :] <= idx[:, None]
        if window is not None:
            keep &= idx[None, :] > idx[:, None] - window
        pairs = int(keep.sum().item())
        elt = q.element_size()
        nbytes = elt * (2 * B * S * H * D + 2 * B * S * Hkv * D)
        b_ms, b_by = bound_ms(nbytes, 4.0 * B * H * D * pairs, dtype)
        lib_kw = ({"is_causal": True} if window is None else {"attn_mask": keep})
        plan = fa.plan_tiles(B, S, H, Hkv, D, bf16=dtype == torch.bfloat16,
                             sm_count=fa.sm_count(q.device.index))
        # the planner's choice, then one and two consumer warpgroups per CTA
        row.update(
            ms=timer.ms(lambda: fa.flash_attention(q, k, v, causal=True, window=window)),
            **{f"ms_wg{w}": timer.ms(lambda w=w: fa.flash_attention(
                q, k, v, causal=True, window=window, warpgroups=w)) for w in (1, 2)},
            plain_ms=timer.ms(lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                              window=window)),
            library_ms=timer.ms(lambda: sdpa(q, k, v, **lib_kw)),
            bound_ms=b_ms, bound_by=b_by, plan=list(plan[:4]))
        row.update(tflops=4.0 * B * H * D * pairs / row["ms"] / 1e9,
                   share_of_bound=b_ms / row["ms"])
    return row, ok


def plan_mask(name, B, C, n_splits, chunk, gen):
    """A [B, C] bool mask on the card, named as in DEC_MASKS, laid out
    against the decode kernel's plan (n_splits chunks of `chunk` slots)."""
    from repro_torch.kernels import decode_attention as da
    m = torch.zeros(B, C, dtype=torch.bool, device="cuda")
    if name == "whole_split_false":            # row 0: split 1 all false
        m[0, :chunk] = True
        m[0, 2 * chunk:] = True
        m[1:, : C // 2] = True
    elif name == "holes":                      # non-prefix, whole tiles masked
        m = torch.rand(B, C, generator=gen, device="cuda") < 0.3
        m[:, 5 * da.TILE: 9 * da.TILE] = False
    elif name == "no_valid_slot":              # row 0 has none
        m[1:, :100] = True
    elif name == "last_split_only":
        m[:, (n_splits - 1) * chunk + 3:] = True
    elif name == "single_slot":
        idx = torch.randint(0, C, (B,), generator=gen, device="cuda")
        m[torch.arange(B, device="cuda"), idx] = True
    else:
        raise ValueError(name)
    return m


def decode_case(timer, gen, B, H, Hkv, D, C, n_valid, dtype, timed=False, mask=None):
    """Mask: the first n_valid slots of each row, or the DEC_MASKS pattern
    named by `mask`."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    q = randn(gen, (B, 1, H, D), dtype)
    k, v = (randn(gen, (B, C, Hkv, D), dtype) for _ in range(2))
    n_splits, chunk = da.plan_splits(B, Hkv, C, da.sm_count(torch.cuda.current_device()),
                                     da.row_groups(H, Hkv))
    if mask is not None:
        mask = plan_mask(mask, B, C, n_splits, chunk, gen)
    else:
        nv = torch.as_tensor(n_valid, device="cuda").reshape(-1, 1)
        mask = (torch.arange(C, device="cuda")[None, :] < nv).expand(B, C).contiguous()
    out = da.decode_attention(q, k, v, mask)
    want = ref.decode_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    row = {"kernel": "decode_attention", "shape": [B, H, Hkv, D, C],
           "n_valid": mask.sum(1).tolist(), "dtype": str(dtype)[6:],
           "n_splits": n_splits, "chunk": chunk, "max_abs_err": err}
    ok = err < TOL[dtype] and bool(torch.isfinite(out.float()).all())
    if timed:
        slots = int(mask.sum().item())
        elt = q.element_size()
        nbytes = elt * (2 * B * H * D + 2 * slots * Hkv * D) + B * C
        b_ms, b_by = bound_ms(nbytes, 4.0 * H * D * slots, dtype)
        row.update(
            ms=timer.ms(lambda: da.decode_attention(q, k, v, mask)),
            plain_ms=timer.ms(lambda: ref.decode_attention_ref(q, k, v, mask)),
            library_ms=timer.ms(lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :])),
            bound_ms=b_ms, bound_by=b_by)
        row.update(tflops=4.0 * H * D * slots / row["ms"] / 1e9,
                   share_of_bound=b_ms / row["ms"])
    return row, ok


def mixed_decode_case(timer, gen, B, H, Hkv, D, C, n_valid):
    """bf16 q over f32 k/v through ``kernels.ops`` (q widened exactly, the
    f32 kernel, the output cast to bf16) against the plain version on the
    same inputs, timed; the library call is SDPA on the widened q."""
    from repro_torch.kernels import ops, ref
    q = randn(gen, (B, 1, H, D), torch.bfloat16)
    k, v = (randn(gen, (B, C, Hkv, D), torch.float32) for _ in range(2))
    nv = torch.as_tensor(n_valid, device="cuda").reshape(-1, 1)
    mask = (torch.arange(C, device="cuda")[None, :] < nv).expand(B, C).contiguous()
    out = ops.decode_attention(q, k, v, mask)
    want = ref.decode_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    slots = int(mask.sum().item())
    nbytes = 2 * 2 * B * H * D + 4 * 2 * slots * Hkv * D + B * C
    b_ms, b_by = bound_ms(nbytes, 4.0 * H * D * slots, torch.float32)
    q32 = q.float()
    row = {"kernel": "decode_attention", "shape": [B, H, Hkv, D, C],
           "n_valid": mask.sum(1).tolist(), "dtype": "bfloat16 q, float32 k/v",
           "max_abs_err": err,
           "ms": timer.ms(lambda: ops.decode_attention(q, k, v, mask)),
           "plain_ms": timer.ms(lambda: ref.decode_attention_ref(q, k, v, mask)),
           "library_ms": timer.ms(lambda: sdpa(q32, k, v, attn_mask=mask[:, None, None, :])),
           "bound_ms": b_ms, "bound_by": b_by}
    row["share_of_bound"] = b_ms / row["ms"]
    ok = (err < TOL[torch.bfloat16] and out.dtype == torch.bfloat16
          and bool(torch.isfinite(out.float()).all()))
    return row, ok


def phase_kernels(timer) -> dict[str, dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows, bad = [], []
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FA_SHAPES:
            rows.append(flash_case(timer, gen, shape, dtype))
        for B, H, Hkv, D, C, nv in DEC_SHAPES:
            rows.append(decode_case(timer, gen, B, H, Hkv, D, C, nv, dtype))
        for shape in SLICE_FA + PREFILL_FA + [WHISPER_FA]:
            rows.append(flash_case(timer, gen, shape, dtype, timed=True))
        for shape in RAGGED_FA:
            rows.append(flash_case(timer, gen, shape, dtype))
        for window in (32, 64, 128):
            rows.append(flash_case(timer, gen, (1, 256, 4, 2, 64), dtype, window,
                                   timed=dtype == torch.float32))
        rows.append(flash_case(timer, gen, (1, 128, 4, 2, 64), dtype, causal=False))
        rows.append(decode_case(timer, gen, *SLICE_DEC, dtype, timed=True))
        for shape in TIMED_DEC + [WHISPER_DEC]:
            rows.append(decode_case(timer, gen, *shape, dtype, timed=True))
        for name in DEC_MASKS:
            rows.append(decode_case(timer, gen, *DEC_MASK_SHAPE, None, dtype, mask=name))
        for name in ("holes", "single_slot"):
            rows.append(decode_case(timer, gen, *DEC_RAGGED_SHAPE, None, dtype, mask=name))
        rows.append(decode_case(timer, gen, *DEC_RAGGED_SHAPE, 999, dtype))
    rows.append(decode_case(timer, gen, 3, 8, 4, 64, 512, [37, 512, 256], torch.float32))
    rows.append(decode_case(timer, gen, 2, 8, 2, 64, 256, [0, 100], torch.float32))
    for shape in MIXED_DEC:
        rows.append(mixed_decode_case(timer, gen, *shape))
    for row, ok in rows:
        print("case " + json.dumps(row), flush=True)
        if not ok:
            bad.append(row)
    check(not bad, f"{len(bad)} kernel case(s) disagree with the plain version")
    # each kernel's summary entry: its first timed f32 case, the llama3.2-1b
    # shape (for decode, SLICE_DEC)
    for row, _ in rows:
        if "ms" in row and row["dtype"] == "float32":
            summary.setdefault(row["kernel"], row)
    return summary


@contextlib.contextmanager
def plain_attention():
    """Route the port's attention through the kernels' plain versions on
    the card, for holding the kernel path against it. Test tooling only."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = ref.flash_attention_ref
    ops.decode_attention = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def phase_serve() -> tuple[dict, object]:
    from repro_torch.configs import ARCHS
    from repro_torch.core.mdp import Config
    from repro_torch.data import synthetic_requests
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving import PipelineServer, StageServer

    variants = [ARCHS["llama3.2-1b"], ARCHS["starcoder2-3b"]]
    t0 = time.perf_counter()
    stage = StageServer("s1", variants, seq_len=32, batch_size=4, seed=0, device="cuda")
    server = PipelineServer([stage])
    torch.cuda.synchronize()
    print(f"serve: built {[c.name for c in variants]} at full width in "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card", flush=True)
    first = synthetic_requests(16, vocab=50_000, seq_len=32, seed=0)
    second = synthetic_requests(8, vocab=50_000, seq_len=32, seed=1)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in first:
        server.submit(r)
    server.process()
    server.apply_config(Config(z=(1,), f=(1,), b=(4,)))
    for r in second:
        server.submit(r)
    done = server.process()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()

    check(len(done) == 24, f"{len(done)} of 24 requests completed")
    check(all(r.result is not None and r.result.shape == (32,) for r in done),
          "a request has no [32] result")
    check(server.switch_count == 1, f"switch_count {server.switch_count} != 1")
    want = variants[0].n_layers * 4 + variants[1].n_layers * 2   # 4 + 2 batches
    check(counts["flash_attention"] == want,
          f"flash launches {counts['flash_attention']} != {want}")
    check(counts["decode_attention"] == 0, "decode kernel launched while serving prefill")
    print(f"serve: 24 requests (16 on {variants[0].name}, switch, 8 on "
          f"{variants[1].name}) in {seconds:.3f}s = {24 / seconds:.2f} req/s wall; "
          f"launches {counts}", flush=True)

    # the served tokens are the kernel path's argmax; hold the kernel path's
    # logits against the plain attention path on the first batch of each variant
    for z, reqs in ((0, first[:4]), (1, second[:4])):
        cfg = variants[z]
        toks = np.stack([r.tokens for r in reqs]) % cfg.vocab
        batch = {"tokens": torch.as_tensor(toks, device="cuda")}
        with torch.inference_mode():
            lk, _ = api.forward(stage.params[z], batch, cfg)
            with plain_attention():
                lp, _ = api.forward(stage.params[z], batch, cfg)
        check(bool(torch.isfinite(lk).all()), f"{cfg.name}: non-finite logits")
        err = (lk - lp).abs().max().item()
        served = np.stack([r.result for r in reqs])
        same = float((lk.argmax(-1).cpu().numpy() == served).mean())
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
        print(f"serve: {cfg.name} kernel vs plain attention logits max|diff| "
              f"{err:.3e} (tol {LOGIT_TOL}), argmax agreement {agree:.4f}, "
              f"served tokens reproduced {same:.4f}", flush=True)
        check(err < LOGIT_TOL, f"{cfg.name}: kernel path logits off by {err}")
        check(same == 1.0, f"{cfg.name}: served tokens not reproduced")
    return counts, stage


def phase_decode(model) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models import api

    cfg = ARCHS["llama3.2-1b"]
    B, C, T = 4, 1024, 32
    ops.reset_launch_counts()
    run = decode_loop(model, cfg, batch=B, context=C, tokens=T, keep_logits=True)
    counts = ops.launch_counts()
    check(counts["decode_attention"] == cfg.n_layers * T,
          f"decode launches {counts['decode_attention']} != {cfg.n_layers * T}")
    check(counts["flash_attention"] == 0, "flash kernel launched while decoding")
    check(run.tokens.shape == (B, T), f"decoded tokens shape {run.tokens.shape}")
    check(bool(torch.isfinite(run.logits).all()), "non-finite decode logits")
    print(f"decode: {B * T} tokens ({cfg.name}, batch {B}, context {C}) in "
          f"{run.seconds:.3f}s = {B * T / run.seconds:.1f} tok/s wall "
          f"(first step {run.first_seconds:.3f}s); launches {counts}", flush=True)

    fed = np.concatenate([run.prompt, run.tokens[:, :-1]], axis=1)    # [B, T]
    with torch.inference_mode():
        lf, _ = api.forward(model, {"tokens": torch.as_tensor(fed, device="cuda")}, cfg)
    err = (lf - run.logits).abs().max().item()
    agree = float((lf.argmax(-1).cpu().numpy() == run.tokens).mean())
    print(f"decode: teacher-forced forward (flash kernel) vs decode logits (decode "
          f"kernel) max|diff| {err:.3e} (tol {LOGIT_TOL}), |logits| max "
          f"{run.logits.abs().max().item():.3f}, argmax agreement {agree:.4f}", flush=True)
    check(err < LOGIT_TOL, f"decode vs forward logits off by {err}")
    return counts


def stage1_spec(controller: str):
    """The live stage of the registered serve2 pipeline (its stage 0 family
    has no model code yet): bursty arrivals, seed 3, 120 s of virtual time,
    under the registered ``controller`` with seed 3."""
    from dataclasses import replace

    from repro_torch import api
    spec = api.ExperimentSpec(
        pipeline=api.PipelineSpec(name="serve2-stage1",
                                  stages=(("llama3.2-1b", "starcoder2-3b"),),
                                  quants=("bf16",)),
        scenario=replace(api.get_scenario("bursty"), seed=3, horizon=120),
        controller=replace(api.get_controller(controller), seed=3),
        backend="runtime", real=True)
    check(list(spec.pipeline.stages[0]) == list(api.get_pipeline("serve2").stages[1]),
          "the live phases no longer serve serve2's stage 1")
    return spec


def serve_live(sess, virtual: dict, tag: str, all_variants: bool) -> tuple[dict, dict]:
    """``sess.serve()`` of a real session with every live stage's executor
    recorded. Checks: every request served, the virtual-time results equal
    ``virtual`` (the same spec with real=False), flash launches = Σ n_layers
    over the executed batches of attention variants, no decode launch, every
    stage executed and each variant of it (``all_variants``), and the kernel
    path's logits against the plain attention path for each variant of each
    stage (on its first batch, or on the stage's first batch where the
    controller never chose it) and on the largest batch. Returns the report
    and the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import api as model_api

    stages = sess.spec.pipeline.stages
    t0 = time.perf_counter()
    servers = sess.stage_servers()
    torch.cuda.synchronize()
    print(f"{tag}: built {[list(s) for s in stages]} at full width in "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card", flush=True)
    batches = []                    # (stage, variant, tokens, output tokens, wall s)

    def recorder(i, execute):
        def recorded(z, tokens):
            t = time.perf_counter()
            out = execute(z, tokens)
            batches.append((i, int(z) % len(stages[i]), tokens, out, time.perf_counter() - t))
            return out
        return recorded

    for i, server in enumerate(servers):
        server.execute = recorder(i, server.execute)   # the executors Session.build_env attaches
    intervals = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = sess.serve(on_step=lambda env, cfg, info: intervals.append(
        (env.runtime.now, tuple(int(z) for z in cfg.z), cfg.f, cfg.b, info["processed"])))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    s = rep["summary"]
    print(f"{tag}: {s['submitted']} requests submitted, {s['served']} served; "
          f"variants per interval {[iv[1] for iv in intervals]} ({stages}), "
          f"{s['switches']} switches", flush=True)
    for t, z, f, b, served in intervals:
        print(f"{tag}: t={t:5.0f}s z={z} f={f} b={b} served={served}", flush=True)
    for i, names in enumerate(stages):
        check(any(st == i for st, *_ in batches), f"{tag}: stage {i} never executed")
        for z, name in enumerate(names):
            sizes = [len(tok) for st, v, tok, _, _ in batches if (st, v) == (i, z)]
            check(bool(sizes) or not all_variants,
                  f"{tag}: stage {i} variant {z} ({name}) never executed")
            print(f"{tag}: stage {i} {name}: {len(sizes)} batches"
                  + (f", sizes {min(sizes)}-{max(sizes)}, {sum(sizes)} requests" if sizes
                     else " (never chosen)"), flush=True)
    exec_s = sum(b[-1] for b in batches)
    print(f"{tag}: serve wall {wall:.3f}s, inside execute {exec_s:.3f}s "
          f"({exec_s / wall:.4f} of it); {len(batches) / wall:.2f} batches/s, "
          f"{s['served'] / wall:.2f} req/s live through the pipeline; launches {counts}",
          flush=True)

    check(s["served"] == s["submitted"] > 0,
          f"{tag}: {s['served']} of {s['submitted']} requests served")
    for key in ("summary", "rewards", "configs"):
        check(rep[key] == virtual[key], f"{tag}: {key} differs from the real=False run")
    want = sum(servers[i].variants[z].n_layers for i, z, *_ in batches
               if servers[i].variants[z].family != "ssm")
    check(counts["flash_attention"] == want,
          f"{tag}: flash launches {counts['flash_attention']} != {want}")
    check(counts["decode_attention"] == 0, f"{tag}: decode kernel launched while serving")

    cases = []                      # (stage, variant, batch index whose tokens feed it)
    for i, names in enumerate(stages):
        first_of_stage = next(k for k, b in enumerate(batches) if b[0] == i)
        for z in range(len(names)):
            ran = [k for k, b in enumerate(batches) if b[:2] == (i, z)]
            cases.append((i, z, ran[0] if ran else first_of_stage))
    largest = max(range(len(batches)), key=lambda k: len(batches[k][2]))
    cases.append(batches[largest][:2] + (largest,))
    for i, z, k in dict.fromkeys(cases):
        _, zk, tokens, out, _ = batches[k]
        server, cfg = servers[i], servers[i].variants[z]
        batch = server._make_batch(tokens, cfg)
        with torch.inference_mode():
            lk, _ = model_api.forward(server.params[z], batch, cfg)
            with plain_attention():
                lp, _ = model_api.forward(server.params[z], batch, cfg)
        check(bool(torch.isfinite(lk).all()), f"{tag}: {cfg.name}: non-finite logits")
        err = (lk - lp).abs().max().item()
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
        line = (f"{tag}: stage {i} batch {k} ({cfg.name}, {len(tokens)} requests) kernel vs "
                f"plain attention logits max|diff| {err:.3e} (tol {LOGIT_TOL}), argmax "
                f"agreement {agree:.4f}")
        if zk == z:
            same = float((lk.argmax(-1).cpu().numpy() == out).mean())
            line += f", served tokens reproduced {same:.4f}"
            check(same == 1.0, f"{tag}: {cfg.name}: served tokens not reproduced")
        print(line, flush=True)
        check(err < LOGIT_TOL, f"{tag}: {cfg.name}: kernel path logits off by {err}")
    return rep, counts


def phase_runtime() -> dict:
    from dataclasses import replace

    from repro_torch import api

    # the capacity controller: the one non-learned controller that switches
    # this stage's variant
    spec = stage1_spec("capacity")
    virtual = api.Session(replace(spec, real=False)).serve()
    return serve_live(api.Session(spec, device="cuda"), virtual, "runtime",
                      all_variants=True)[1]


def rel_err(want: torch.Tensor, got: torch.Tensor) -> float:
    """max |want - got| over max(1, max |want|), both on the CPU."""
    want, got = want.detach().float().cpu(), got.detach().float().cpu()
    return (want - got).abs().max().item() / max(1.0, want.abs().max().item())


def synced_ms(fn) -> float:
    """Wall time of one call of ``fn`` between two synchronisations, in ms."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def profiled(tag: str, fn, phase: str = "opd"):
    """One call of ``fn`` (after a warm-up call) under torch.profiler: wall
    time, device kernel time and launches, the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    print(f"{phase}: profile {tag}: wall {wall_ms:.3f} ms (profiler on), device kernels "
          f"{busy_ms:.3f} ms in {launches} launches, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {wall_ms * 1e3 / max(launches, 1):.1f} us of "
          f"wall per launch; top: " + "; ".join(
              f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms" for e in top),
          flush=True)


def to_cpu_opt(opt: dict) -> dict:
    return {"m": {k: v.cpu() for k, v in opt["m"].items()},
            "v": {k: v.cpu() for k, v in opt["v"].items()}, "step": opt["step"]}


def phase_opd() -> dict:
    """Train the registered opd controller on the card, hold its networks
    and one update against the same computation on the CPU, serve the live
    stage with the trained policy, train the load predictor."""
    import copy
    from dataclasses import replace

    from repro_torch import api
    from repro_torch.cluster import make_trace
    from repro_torch.core import policy, ppo, predictor, vecenv

    spec = stage1_spec("opd")
    sess = api.Session(spec, device="cuda")
    stamps = [time.perf_counter()]

    def log(msg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        print(f"opd: {msg} ({(stamps[-1] - stamps[-2]) * 1e3:.1f} ms)", flush=True)

    sess.train(log=log)
    tr = sess.trainer
    params, hist = tr.params, tr.history
    episode_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    check(hist["expert"] == [False, True, False, True],
          f"opd: expert episodes {hist['expert']} != [False, True, False, True]")
    check(all(np.isfinite(hist[k]).all() for k in
              ("reward", "loss", "policy_loss", "value_loss", "entropy")),
          "opd: non-finite training history")
    on_card = (list(params.parameters()) + list(tr.opt["m"].values())
               + list(tr.opt["v"].values()))
    check(all(t.device.type == "cuda" for t in on_card),
          "opd: a policy parameter or optimiser moment is not on the card")
    n_params = sum(p.numel() for p in params.parameters())
    print(f"opd: trained {len(hist['reward'])} episodes ({tr.num_envs} envs, expert "
          f"{hist['expert']}) on {next(params.parameters()).device}, {n_params} policy "
          f"parameters; episode wall ms {[round(t, 1) for t in episode_ms]}", flush=True)

    # a fresh on-policy batch of the trained policy: 4 envs x 120 intervals
    states, actions, logps, _, adv, returns = tr._rollout_vec(len(hist["reward"]) + 1)
    mb, cfg = tr.ppo.minibatch, tr.ppo
    kw = dict(clip_eps=cfg.clip_eps, c1=cfg.c1, c2=cfg.c2, lr=cfg.lr)
    bsel = np.random.default_rng(0).integers(0, len(tr.expert_states), mb)
    batch = [torch.as_tensor(a[:mb], device="cuda")
             for a in (states, actions, logps, adv, returns)]
    batch += [torch.as_tensor(a[bsel], device="cuda")
              for a in (tr.expert_states, tr.expert_actions)]
    p_t, o_t = copy.deepcopy(params), copy.deepcopy(tr.opt)

    def update():
        nonlocal p_t, o_t
        p_t, o_t, *_ = ppo.ppo_minibatch_update(p_t, o_t, *batch, cfg.bc_coef, **kw)

    upd_ms = [synced_ms(update) for _ in range(25)][5:]
    print(f"opd: ppo_minibatch_update (minibatch {mb}, BC batch {mb}) median "
          f"{float(np.median(upd_ms)):.3f} ms, min {min(upd_ms):.3f} ms over "
          f"{len(upd_ms)} synchronised calls", flush=True)
    profiled("ppo_minibatch_update", update)
    state = torch.as_tensor(states[0], device="cuda")

    def decision():
        with torch.no_grad():
            policy.sample_action(params, state, None, greedy=True)[0].cpu()

    profiled("one greedy decision (sample_action + copy to host)", decision)

    # -- the card against the plain CPU computation on the same inputs
    cpu_params, cpu_opt = copy.deepcopy(params).cpu(), to_cpu_opt(tr.opt)
    s_all, a_all = torch.as_tensor(states), torch.as_tensor(actions)
    with torch.no_grad():
        on_gpu = policy.log_prob_entropy(params, s_all.cuda(), a_all.cuda())
        on_cpu = policy.log_prob_entropy(cpu_params, s_all, a_all)
    lp_err = max(rel_err(c, g) for c, g in zip(on_cpu, on_gpu, strict=True))
    print(f"opd: log_prob_entropy of {len(s_all)} trained-episode states, card vs CPU "
          f"max rel err {lp_err:.3e} (tol 1e-4)", flush=True)
    check(lp_err < 1e-4, f"opd: log_prob_entropy card vs CPU off by {lp_err}")
    g_p, g_o = copy.deepcopy(params), copy.deepcopy(tr.opt)
    c_p, c_o = copy.deepcopy(cpu_params), copy.deepcopy(cpu_opt)
    g_p, g_o, *g_l = ppo.ppo_minibatch_update(g_p, g_o, *batch, cfg.bc_coef, **kw)
    c_p, c_o, *c_l = ppo.ppo_minibatch_update(c_p, c_o, *(b.cpu() for b in batch),
                                              cfg.bc_coef, **kw)
    loss_err = max(rel_err(c, g) for c, g in zip(c_l, g_l, strict=True))
    upd_err = max((c - g.cpu()).abs().max().item() for c, g in
                  zip(c_p.parameters(), g_p.parameters(), strict=True))
    # 1e-4, not 1e-5: AdamW maps a gradient near eps = 1e-8 to an update of
    # order lr = 3e-4 whatever its last bits (tests/test_torch_opd.py)
    print(f"opd: one ppo_minibatch_update card vs CPU: losses max rel err "
          f"{loss_err:.3e} (tol 1e-5), params max abs err {upd_err:.3e} (tol 1e-4)",
          flush=True)
    check(loss_err < 1e-5, f"opd: PPO losses card vs CPU off by {loss_err}")
    check(upd_err < 1e-4, f"opd: PPO update card vs CPU off by {upd_err}")

    envs = [tr.make_env(ppo.VEC_SEED_BASE + 1000 + i) for i in range(4)]
    traces = torch.as_tensor(np.stack([e.trace for e in envs]).astype(np.float32))
    n_steps = envs[0].n_steps
    g_traj = vecenv.vec_rollout(params, tr._tables, traces.cuda(), None, n_steps=n_steps,
                                weights=tr._weights, greedy=True)
    c_traj = vecenv.vec_rollout(cpu_params, vecenv.tables_from_pipeline(tr.pipe), traces,
                                None, n_steps=n_steps, weights=tr._weights, greedy=True)
    g_act, c_act = g_traj["actions"].cpu(), c_traj["actions"]
    r_err, compared, ties = 0.0, 0, []
    for i in range(len(envs)):
        diff = (g_act[i] != c_act[i]).any(dim=1).nonzero()
        t_div = int(diff[0]) if len(diff) else n_steps
        if t_div < n_steps:
            # a flipped greedy choice must be a near-tie; the episodes part there
            with torch.no_grad():
                logits, _ = policy.apply_policy(cpu_params, c_traj["states"][i, t_div][None])
            for h, lg in enumerate(logits):
                if g_act[i, t_div, h] != c_act[i, t_div, h]:
                    top = torch.topk(lg[0], 2).values
                    ties.append((i, t_div, h, (top[0] - top[1]).item()))
        compared += t_div
        if t_div:
            r_err = max(r_err, (g_traj["rewards"][i, :t_div].cpu()
                                - c_traj["rewards"][i, :t_div]).abs().max().item())
    print(f"opd: greedy vec_rollout of {len(envs)} envs x {n_steps} intervals, card vs "
          f"CPU: actions equal on {compared} of {len(envs) * n_steps} steps, near-tie "
          f"flips {ties}, rewards max abs err {r_err:.3e} (tol 1e-4)", flush=True)
    check(all(gap < 1e-4 for *_, gap in ties), f"opd: greedy actions differ at {ties}")
    check(r_err < 1e-4, f"opd: greedy rollout rewards card vs CPU off by {r_err}")

    # -- vec_rollout wall time on the paper's 4-stage pipeline
    pipe4 = api.get_pipeline("paper-4stage").build()
    sizes4 = policy.head_sizes(pipe4)
    pol4 = policy.init_policy(0, pipe4.n_tasks * 9, sizes4, device="cuda")
    tables4 = vecenv.tables_from_pipeline(pipe4, device="cuda")
    for n_envs in (4, 64):
        trs = torch.as_tensor(np.stack([make_trace("fluctuating", seed=i, seconds=1200)
                                        for i in range(n_envs)]).astype(np.float32),
                              device="cuda")
        gens = vecenv.env_generators(0, range(n_envs), "cuda")
        roll = lambda: vecenv.vec_rollout(pol4, tables4, trs, gens, n_steps=120,  # noqa: E731
                                          weights=tr._weights)
        first = synced_ms(roll)
        ms = synced_ms(roll)
        print(f"opd: vec_rollout paper-4stage (state_dim {pipe4.n_tasks * 9}, "
              f"{len(sizes4)} heads), {n_envs} envs x 120 intervals: {ms:.1f} ms "
              f"(first call {first:.1f} ms)", flush=True)
        profiled(f"vec_rollout paper-4stage, {n_envs} envs", roll)

    # -- serve the live stage with the trained policy
    virtual = api.Session(replace(spec, real=False), device="cuda").with_params(params).serve()
    rep, counts = serve_live(sess, virtual, "opd", all_variants=False)
    dts = np.asarray(rep["decision_times"]) * 1e3
    print(f"opd: decision d_t on the card over {len(dts)} decisions: median "
          f"{float(np.median(dts)):.3f} ms, max {float(dts.max()):.3f} ms", flush=True)

    # -- the 25-unit LSTM load predictor, one epoch over the scenario's train traces
    scen = spec.scenario
    ptraces = [scen.train_trace(ep) for ep in range(spec.controller.train_episodes)]
    scale = float(max(t.max() for t in ptraces))
    X, _ = predictor.make_dataset(ptraces, scale=scale)
    n_upd = len(range(0, len(X) - 256 + 1, 256))
    lines = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = predictor.train_predictor(ptraces, scale=scale, epochs=1, seed=3,
                                   log=lines.append, device="cuda")
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    check(all(p.device.type == "cuda" for p in pp.parameters()),
          "opd: predictor parameters not on the card")
    Xe, ye = predictor.make_dataset([scen.train_trace(len(ptraces))], scale=scale)
    with torch.no_grad():
        g = predictor.predict_batch(pp, torch.as_tensor(Xe, device="cuda"))
        c = predictor.predict_batch(copy.deepcopy(pp).cpu(), torch.as_tensor(Xe))
    p_err = (g.cpu() - c).abs().max().item()
    print(f"opd: {lines[-1]}, {len(X)} windows, {n_upd} steps of batch 256 "
          f"in {train_ms:.1f} ms ({train_ms / n_upd:.2f} ms per train step incl. set-up); "
          f"smape {predictor.smape(pp, [scen.train_trace(len(ptraces))], scale=scale):.2f}% "
          f"on a held-out trace; predict_batch of {len(Xe)} windows card vs CPU "
          f"max abs err {p_err:.3e} (tol 1e-5)", flush=True)
    check(bool(torch.isfinite(g).all()), "opd: non-finite predictor output")
    check(p_err < 1e-5, f"opd: predict_batch card vs CPU off by {p_err}")
    return counts


def fill_cache(cache: dict, gen) -> None:
    """Random self-attention KV in place, and a different number of valid
    slots per row (17, 22, 27, 32, 5, ... of C = 32): the step's attention
    then depends on q, which it does not over the grid's one valid slot."""
    C = cache["k"].shape[2]                          # [L, B, C, kv, hd]
    for name in ("k", "v"):
        t = cache[name]
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
    cache["pos"].copy_((torch.arange(len(cache["pos"]), device="cuda") * 5 + 16) % C)


def graph_checks(ex) -> None:
    """Every captured step of the grid, replayed, against the same step run
    eagerly (the same kernels: equal) and run eagerly on the plain attention
    path (the kernels against their plain versions inside full-depth bf16
    and int8 steps, within bf16 rounding: TOL[bf16] of max(1, max |logit|)).
    First at the grid's own state, one valid slot per row; then with
    random caches and several valid slots (fill_cache), attention archs
    only. Rewrites the entries' caches: run it last."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    tol = TOL[torch.bfloat16]
    worst: dict = {}
    for key, entry in ex.cache.entries.items():
        for state in ("grid", "filled"):
            if state == "filled":
                if "k" not in entry.cache:
                    continue                         # xLSTM: no attention cache
                fill_cache(entry.cache, gen)
            graph = entry.replay()[0].float().clone()
            eager = entry.eager()[0].float()
            with plain_attention():
                plain = entry.eager()[0].float()
            scale = max(1.0, plain.abs().max().item())
            errs = ((graph - eager).abs().max().item() / scale,
                    (graph - plain).abs().max().item() / scale)
            tag = f"{key.arch}:{key.quant} b{key.batch} {state}"
            check(bool(torch.isfinite(graph).all()), f"calibrate: {tag}: non-finite logits")
            check(errs[0] < tol and errs[1] < tol,
                  f"calibrate: {tag}: graph logits off the eager step's by {errs[0]}, "
                  f"off the plain attention path's by {errs[1]}")
            w = worst.setdefault((key.arch, key.quant, state), [0.0, 0.0, []])
            w[0], w[1] = max(w[0], errs[0]), max(w[1], errs[1])
            w[2].append(key.batch)
    for (arch, quant, state), (e_eager, e_plain, batches) in worst.items():
        print(f"calibrate: {arch}:{quant} {state} state, b = {sorted(batches)}: graph vs "
              f"eager logits max rel diff {e_eager:.3e}, graph vs plain attention path "
              f"{e_plain:.3e} (tol {tol}), all finite", flush=True)


def phase_calibrate() -> dict:
    """Measured stage execution on the card: the calibration grid (serve2's
    four archs at full width, bf16 and int8, b = 1..32, CUDA-graph replays
    with the eager steps beside them), the graphs' logits against the eager
    steps' and the plain attention path's, then the whole serve2 loop live
    on the fitted table, under the capacity and the random controller."""
    from dataclasses import replace

    from repro_torch import api
    from repro_torch.cluster import calibration, executor
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate

    ex = executor.StageExecutor("cuda", seq_len=32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    payload = calibrate.run(ex, log=lambda m: print(m, flush=True))
    grid_counts = ops.launch_counts()
    print(f"calibrate: grid of {len(payload['rows'])} rows and its repeat pass in "
          f"{time.perf_counter() - t0:.1f}s; launches {grid_counts} (eager steps and "
          f"captures; a replay launches from the graph and counts nothing)", flush=True)
    table = calibration.CalibrationTable.from_dict(payload["table"])
    check(len(table.variants) == 8, f"calibrate: table has {len(table.variants)} variants")
    check(payload["cache"]["hit_rate_repeat"] >= 0.9,
          f"calibrate: hit_rate_repeat {payload['cache']['hit_rate_repeat']} < 0.9")
    for row in payload["rows"]:
        cfg = ex.arch_config(row["arch"])
        want = 0 if cfg.family == "ssm" else cfg.n_layers
        check(row["launches"]["decode_attention"] == want and
              row["launches"]["flash_attention"] == 0,
              f"calibrate: {row['arch']} b{row['batch']} captured launches {row['launches']}")
        check(0 < row["graph_s"] < np.inf and 0 < row["eager_s"] < np.inf,
              f"calibrate: {row['arch']} b{row['batch']} latencies {row}")
    for name, v in sorted(payload["variants"].items()):
        ratio = [e / g for e, g in zip(v["eager_s"], v["measured_s"], strict=True)]
        print(f"calibrate: {name}: graph ms {[round(x * 1e3, 4) for x in v['measured_s']]}, "
              f"eager ms {[round(x * 1e3, 4) for x in v['eager_s']]}, eager/graph "
              f"{[round(r, 2) for r in ratio]}", flush=True)

    print(f"calibrate: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB over the grid", flush=True)
    # where a step's time goes: device kernels and gaps in one replay, and
    # in the same step run eagerly
    for arch in calibrate.ARCHS:
        for b in (min(calibrate.BATCHES), max(calibrate.BATCHES)):
            entry, _ = ex.compiled_step(arch, b, "bf16")
            profiled(f"{arch}:bf16 b{b} graph replay", entry.replay, "calibrate")
            profiled(f"{arch}:bf16 b{b} eager step", entry.eager, "calibrate")
    graph_checks(ex)
    del ex, entry
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the whole serve2 loop live on the card's own physics
    calibration.register_table("h100-serve2", table)
    # the registered serve2 pipeline, both stages, on the measured table:
    # stage1_spec's scenario under the capacity controller
    spec = api.ExperimentSpec(
        pipeline=replace(api.get_pipeline("serve2"), perf_source="calibrated",
                         calibration="h100-serve2"),
        scenario=replace(api.get_scenario("bursty"), seed=3, horizon=120),
        controller=replace(api.get_controller("capacity"), seed=3),
        backend="runtime", real=True)
    pipe = spec.pipeline.build()
    covered, total = calibration.coverage(pipe, table)
    print(f"calibrate: table covers {covered}/{total} of serve2's variants", flush=True)
    check(covered == total == 4, f"calibrate: coverage {covered}/{total}")
    virtual = api.Session(replace(spec, real=False)).serve()
    analytic = api.Session(replace(spec, real=False, pipeline=replace(
        spec.pipeline, perf_source="analytic", calibration=None))).serve()
    torch.cuda.reset_peak_memory_stats()
    rep, loop_counts = serve_live(api.Session(spec, device="cuda"), virtual, "calibrate",
                                  all_variants=False)
    s, a = rep["summary"], analytic["summary"]
    print(f"calibrate: calibrated (H100) vs analytic (TPU v5e) virtual run: p50 "
          f"{s['p50']:.6f} vs {a['p50']:.6f} s, p99 {s['p99']:.6f} vs {a['p99']:.6f} s, "
          f"mean cost {np.mean(rep['cost']):.4f} vs {np.mean(analytic['cost']):.4f}, mean "
          f"batch {s['mean_batch_size']:.3f} vs {a['mean_batch_size']:.3f} (reported only)",
          flush=True)
    print(f"calibrate: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB over the live loop", flush=True)
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    # the capacity controller keeps one variant per stage on this table, so
    # the same calibrated spec again, 30 s under the random controller (seed
    # 0, as tests/test_torch_families.py serves serve2), which executes
    # every variant of both stages
    cycle = replace(spec, scenario=replace(spec.scenario, horizon=30),
                    controller=replace(api.get_controller("random"), seed=0))
    virtual = api.Session(replace(cycle, real=False)).serve()
    _, cycle_counts = serve_live(api.Session(cycle, device="cuda"), virtual,
                                 "calibrate-random", all_variants=True)
    return {k: grid_counts[k] + loop_counts[k] + cycle_counts[k] for k in grid_counts}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    print(f"env: built {list(build.KERNELS)} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"ptxas {name}: {instance_name(line.split(chr(39))[1])}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    sass_check()

    summary = phase_kernels(Timer())
    serve_counts, stage = phase_serve()
    decode_counts = phase_decode(stage.params[0])
    del stage                       # the runtime phase builds its own models
    gc.collect()
    torch.cuda.empty_cache()
    runtime_counts = phase_runtime()
    gc.collect()
    torch.cuda.empty_cache()
    opd_counts = phase_opd()
    gc.collect()
    torch.cuda.empty_cache()
    calibrate_counts = phase_calibrate()

    kernels = []
    for name in build.KERNELS:
        launches = (serve_counts[name] + decode_counts[name] + runtime_counts[name]
                    + opd_counts[name] + calibrate_counts[name])
        check(launches > 0, f"{name} never launched on the main path")
        row = summary[name]
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": row["max_abs_err"],
                        "max_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": row["shape"], "dtype": row["dtype"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
