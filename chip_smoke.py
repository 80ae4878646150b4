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
  forecast the registered lstm-multi and mlstm-multi forecasters trained on
           the card through Session.build_forecaster (serve2, bursty at
           25 req/s, seed 3): MSE per epoch, training wall time, SMAPE and
           pinball per horizon on held-out traces, forecast_batch and one
           training step held against a CPU copy, a second training to
           report whether the card repeats it; one forecaster call's
           synchronised time; Session.serve of the whole serve2 pipeline
           live under proactive-capacity with lstm-multi on the card (f32,
           analytic perf model, 120 s): the runtime phase's checks,
           prewarms > 0, d_t; the proactive OPD controller trained on the
           card (2 episodes, 4 envs) and served 120 s in virtual time; the
           registered fleet-3tenant-hetero and a copy whose interactive
           tenant runs proactive-capacity with lstm-multi, offered = served
           + shed for every tenant
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
           controller, bursty, seed 3, 20 s): the runtime phase's checks on
           every stage, and the calibrated virtual p50/p99 and cost beside
           the analytic (TPU v5e) run's; then the same spec for 30 s under
           the random controller, which executes every variant of both stages
  families the registered serve3 (stage 2: granite-moe-3b-a800m, zamba2-2.7b)
           served live at full width in f32 with the runtime phase's checks,
           under the greedy controller (20 s) and the random one (seed 2,
           30 s, which executes every variant of every stage); the plain
           path of a MoE replays the kernel path's dispatch plans
           (moe_plans); granite-3-8b and llava-next-mistral-7b at full width
           in bf16 (ArchConfig.dtype) through one StageServer:
           make_prefill_step (llava: 576 patches + 32 tokens),
           8 decode steps through make_serve_step, each against the plain
           attention path; granite-moe's and zamba2's decode steps captured
           in CUDA graphs (bf16 and int8, b = 1 and 32), profiled, and held
           against their eager steps and the plain attention path
  paper4   the registered paper-4stage served live at full width in bf16
           (Session(..., dtype="bfloat16"), about 50.5 GiB) under the random
           controller (seed 2; bursty, seed 3, 40 s), which executes every
           variant of every stage, with the runtime phase's checks (served +
           shed = offered, virtual-time results equal real=False, each
           variant's logits against the plain attention path within 4e-2 of
           max(1, max-abs), MoE plans replayed; every flash call within two
           bf16 ulps of its plain version on its own inputs; where the
           library's attention (SDPA) also misses 4e-2 against the plain
           path, the variant's weights widened to f32 hold the kernel path
           at 5e-3); weights and peak GiB, live batches/s, the executor's
           share of the wall, ms a batch per variant; the flash kernel timed
           at the serve's largest batch
  twin     the discrete-event runtime twin: Session.train of the registered
           opd controller with train_backend="runtime" on serve3-hetero
           (bursty, 25 req/s, 8 envs, 2 episodes), one fixed action sequence
           replayed through the twin on the card with captured blocks, on the
           card eagerly (its first 4 intervals), on the CPU and through the
           NumPy RuntimeEnv (equal served counts and rewards within 1e-5 of
           the CPU; within 2 requests and 0.15 of RuntimeEnv; captured equal
           to eager bit for bit), the same replay under the twins' sanitizer
           (analysis.sanitize: the eager loop, every op checked) equal to the
           captured one, a NaN planted in one latency coefficient raising
           under the sanitizer and not without it, and
           launch/runtime_train_throughput.py at 1, 8 and 32 envs with
           captured blocks against the RuntimeEnv loop
  train    launch/train.py with llama3.2-1b at published width and depth
           (f32, batch 4 x 1024, 3 steps, each layer rematerialised as the
           published config says): finite losses, grad_norm > 0,
           every parameter changed after step 1, step ms, tokens/s, peak
           memory beside PR 19's (no remat then), one profiled step with
           _sdpa's share; one --microbatch 2 step from the same weights
           (loss 1e-5 rel, params 1e-4); one step at 2 layers, batch
           1 x 1024, held against the CPU with the card's weights (loss
           1e-5, grad_norm 1e-4, params 1e-4); both kernel wrappers refuse
           an input that requires grad; the phase launches no attention
           kernel (training computes the reference's _sdpa)
  figures  the paper's figures through launch/fig{7_convergence,45_workloads,
           6_decision_time,3_predictor}.py at cut sizes: trained_opd on the
           card (3 episodes) and fig7 on its history; fig45 on fluctuating
           (100 s) and the bursty proactive section (120 s); fig6 on P1-P3
           (2 decisions); fig3 on one regime, one epoch per network. Random,
           Greedy and IPA equal device="cpu"; the card's policy and its CPU
           copy take the same greedy actions over the fig45 episode (flips
           only at near-ties); predict_batch card vs CPU 1e-5; served + shed
           = offered, prewarms > 0 for proactive_capacity; every OPD d_t
           below 1 s; no attention kernel launched; payloads under
           chiprun_out/figures_smoke/
  mesh     the sharded serving program: granite-moe-3b-a800m at full width in
           f32 on a (1, 2) mesh of two ranks sharing the card over gloo
           (distributed.launch.run_on_mesh): StageExecutor(mesh=) decode, 8
           steps at b = 4, and a 32-token api.forward prefill with shard_h,
           logits within 1e-4 of the one-rank run (MoE plans replayed), each
           rank's flash and decode launches > 0, per-rank weight GiB and the
           slowest rank's step; an ep2d MoE layer at granite-moe's widths on
           (2, 2) against one rank; the decode kernel's lse output (an empty
           row gives 0 and -inf) against its plain version
  mesh_train
           the sharded train step: llama3.2-1b at published width and depth
           in f32 on a (2, 2) mesh of four ranks sharing the card over gloo,
           batch 4 x 512, shard_h, ZeRO-1 moments, two steps, and
           granite-moe-3b-a800m at published width cut to 4 layers, one step
           with the MoE plans replayed; whisper-small (1500 encoder frames)
           and xlstm-125m at published width and depth, zamba2-2.7b cut to 6
           layers (one group under the shared block) and llava-next cut to
           2 layers (576 patches), batch 2, one step each, their vision
           patches or encoder frames drawn by parity.numpy_lm_batch; each
           against the one-rank step on
           the card from the same seed (loss 1e-5, grad_norm 1e-4, every
           parameter and moment block 1e-4 of max(1, max-abs) after the last
           step), per-rank GiB of parameters, grads and moments beside the
           rules' bytes, peak and step ms
  dryrun   launch/dryrun.py: every (arch, INPUT_SHAPES) step counted on fake
           tensors on the card's (1, 1) mesh (params, moments, cache and
           batch bytes through distributed.sharding's rules, flops, minimum
           and aten bytes and the peak of live storage through
           launch/step_cost.py, model flops, roofline terms against the
           H100's peaks), by the launcher in worker processes on the host's
           CPU, started before the twin phase and run beside it and the
           train, figures, mesh and mesh_train phases; then up to three records that fit
           run on the card (decode shapes first): ms, peak memory against
           the counted peak (at most +25%), share of the bound; records
           under chiprun_out/dryrun/
  bench    the throughput launchers at cut sizes: launch/train_throughput.py
           (one 300 s episode on the legacy loop, vec_rollout at 1 and 32
           envs), launch/runtime_throughput.py --quick (served == submitted
           in every scenario), launch/roofline.py over the dryrun phase's
           records (one row per OK record); no attention kernel launched;
           payloads under chiprun_out/bench_smoke/
`--phases NAME ...` runs only the named phases after the build, without the
kernel summary and the device line.
The kernels phase also holds whisper-small's g = 1 shapes (flash B4 S32
H12 Hkv12 D64, decode B4 H12 C32) in both dtypes and bf16 q over an f32
cache (llama3.2-1b's, starcoder2-3b's and whisper-small's decode steps),
all timed, the decode cases at 1, 9, 17 and 32 valid slots per row, and
the families' shapes in both dtypes, timed: flash B4 S32 H32 Hkv32 D80
(zamba2's shared block, g = 1), B4 S32 H24 Hkv8 D64 (granite-moe, g = 3)
and B1 S608 H32 Hkv8 D128 (llava's prefill), decode B4 H32 Hkv32 D80 and
B4 H24 Hkv8 D64 at C32 (1/9/17/32 valid) and B1 H32 Hkv8 D128 C640,
and flash at granite-3-8b's B4 S32 H32 Hkv8 D128 in both dtypes, timed;
and the MoE combine kernel (moe_combine) bit for bit against its plain
version at granite-moe's layer in both cells (B32 S448, E 40 padded to 48,
C 112, d 1536, routed by the layer's router on random tokens), at B8 S448
and at a decode step (B32 S1), in f32 and bf16, timed beside its byte bound,
the plain version and the port's earlier fill-scatter-sum combine that it
replaces (replaced_ms). The serves check moe_combine launches = MoE layers x
forwards.
The last two lines are the kernel summary and the device line, as JSON.
Imports only torch, numpy and the port (never jax or the JAX package).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import re
import shutil
import signal
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
# One flash call of a live serve against the plain version on its own
# inputs, relative to max(1, max |plain|): bf16 at two units in the last
# place of the largest output (2^-7 each; a kernel that rounds its
# probabilities to bf16 moves an output by one), f32 as the kernel tests.
CALL_TOL = {torch.float32: TOL[torch.float32], torch.bfloat16: 2.0 ** -6}
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
# the families phase's attention: zamba2-2.7b's shared block (MHA, D = 80),
# granite-moe-3b-a800m (g = 3) at a serving prefill and at the calibrate
# grid's decode cache, and llava-next-mistral-7b's prefill of 576 patches and
# 32 tokens (S = 608, off the 64-row grid) and its decode over 640 slots
FAMILY_FA = [(4, 32, 32, 32, 80), (4, 32, 24, 8, 64), (1, 608, 32, 8, 128)]
FAMILY_DEC = [(4, 32, 32, 80, 32, GRID_NV), (4, 24, 8, 64, 32, GRID_NV),
              (1, 32, 8, 128, 640, 616)]            # (B, H, Hkv, D, C, nv)
# paper-4stage's stage 3: granite-3-8b's serving prefill (g = 4, D = 128)
PAPER4_FA = [(4, 32, 32, 8, 128)]
# granite-moe's MoE layer (d 1536, 40 experts padded to 48, top-8, capacity
# factor 1.25): both cells' batch of 32 x 448 (C 112), a batch of 8 and a
# decode step (C 1); (B, S)
MOE_COMBINE_SHAPES = [(32, 448), (8, 448), (32, 1)]
SASS_OPS = ("HGMMA", "HMMA")
SOURCES = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:111"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:91"),
           "moe_combine": ("src/repro_torch/kernels/csrc/moe_combine.cu",
                           "none: the JAX package's MoE combine is plain jnp "
                           "(src/repro/nn/moe.py:89)")}


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


def scatter_sum_combine(ye, gsel, tok_idx, S: int, out_dtype):
    """The port's combine before the kernel, as a yardstick only: the gated
    outputs scattered into a zero-filled f32 [B, E, S, d] buffer, summed over
    E, cast to ``out_dtype``."""
    B, E, C, d = ye.shape
    ye = ye * (gsel * (gsel > 0))[..., None].to(ye.dtype)
    buf = torch.zeros((B, E, S, d), dtype=torch.float32, device=ye.device)
    buf.scatter_(2, tok_idx[..., None].expand(B, E, C, d), ye.to(torch.float32))
    return buf.sum(dim=1).to(out_dtype)


def moe_combine_case(timer, gen, B, S, dtype):
    """moe_combine at granite-moe's layer (B, S): the dispatch plan from the
    layer's own router on random tokens, ye in the expert FFN's layout (E
    outermost), the output in ye's dtype as the serving path asks. Bit for
    bit against the plain version; timed beside the byte bound (the used
    rows of ye, slot_of, gsel, y written once), the plain version and the
    scatter-and-sum combine it replaced."""
    import importlib

    from repro_torch import nn as tnn
    from repro_torch.kernels import ops, ref
    moe_mod = importlib.import_module("repro_torch.nn.moe")
    d, E, k = 1536, 40, 8
    params = tnn.MoE(d, 512, E, device="cuda", generator=gen)
    x = randn(gen, (B, S, d), torch.float32)
    gsel, tok_idx, _, C = moe_mod._route(params, x, top_k=k, capacity_factor=1.25,
                                         E_phys=moe_mod._phys_experts(E))
    gsel = gsel.contiguous()
    slot_of = moe_mod._slot_of(tok_idx, gsel, S)
    Ep = gsel.shape[1]
    ye = randn(gen, (Ep, B, C, d), dtype).transpose(0, 1)
    out = ops.moe_combine(ye, gsel, slot_of)
    want = ref.moe_combine_ref(ye, gsel, slot_of)
    old = scatter_sum_combine(ye, gsel, tok_idx, S, dtype)
    torch.cuda.synchronize()
    used = int((gsel > 0).sum().item())
    elt = ye.element_size()
    nbytes = used * d * elt + slot_of.numel() * 4 + gsel.numel() * 4 + B * S * d * elt
    b_ms, b_by = bound_ms(nbytes, 2.0 * used * d, dtype)
    row = {"kernel": "moe_combine", "shape": [B, S, Ep, C, d], "dtype": str(dtype)[6:],
           "slots_used": used, "slots": gsel.numel(),
           "max_abs_err": (out.float() - want.float()).abs().max().item(),
           "bitwise": bool(torch.equal(out, want)),
           "vs_replaced_max_abs": (out.float() - old.float()).abs().max().item(),
           "ms": timer.ms(lambda: ops.moe_combine(ye, gsel, slot_of)),
           "plain_ms": timer.ms(lambda: ref.moe_combine_ref(ye, gsel, slot_of)),
           "replaced_ms": timer.ms(lambda: scatter_sum_combine(ye, gsel, tok_idx, S, dtype)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    row["share_of_bound"] = b_ms / row["ms"]
    return row, row["bitwise"] and out.dtype == dtype


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
        for shape in TIMED_DEC + [WHISPER_DEC] + FAMILY_DEC:
            rows.append(decode_case(timer, gen, *shape, dtype, timed=True))
        for shape in FAMILY_FA + PAPER4_FA:
            rows.append(flash_case(timer, gen, shape, dtype, timed=True))
        for name in DEC_MASKS:
            rows.append(decode_case(timer, gen, *DEC_MASK_SHAPE, None, dtype, mask=name))
        for name in ("holes", "single_slot"):
            rows.append(decode_case(timer, gen, *DEC_RAGGED_SHAPE, None, dtype, mask=name))
        rows.append(decode_case(timer, gen, *DEC_RAGGED_SHAPE, 999, dtype))
        for B, S in MOE_COMBINE_SHAPES:
            rows.append(moe_combine_case(timer, gen, B, S, dtype))
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


@contextlib.contextmanager
def attention_held(errs: list):
    """Hold every flash call of the block against the plain version on the
    same q, k, v: appends max |kernel - plain| / max(1, max |plain|) per
    call. Test tooling only."""
    from repro_torch.kernels import ops, ref
    kernel = ops.flash_attention

    def held(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw).float()
        errs.append(((out.float() - want).abs().max() / max(1.0, want.abs().max().item()))
                    .item())
        return out

    ops.flash_attention = held
    try:
        yield
    finally:
        ops.flash_attention = kernel


@contextlib.contextmanager
def library_attention():
    """Route the port's flash calls through PyTorch's own attention
    (``scaled_dot_product_attention``) on the same q, k, v: a second correct
    attention path, independent of the port's kernel and of its plain
    version. Test tooling only."""
    from repro_torch.kernels import ops
    saved = ops.flash_attention

    def library(q, k, v, *, causal=True, window=None):
        mask = None
        if window is not None:
            i = torch.arange(q.shape[1], device=q.device)[:, None]
            j = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = (j > i - window) & ((j <= i) | (not causal))
        out = sdpa(q, k, v, is_causal=causal and mask is None, attn_mask=mask)
        return out.transpose(1, 2).contiguous()

    ops.flash_attention = library
    try:
        yield
    finally:
        ops.flash_attention = saved


@contextlib.contextmanager
def moe_plans(plans: list, replay: bool):
    """Record the dispatch plans (``nn.moe._route``'s results) of the port's
    MoE layers into ``plans``, or, with ``replay``, hand them back in the
    same order instead of routing. A routing choice near a tie (the k-th
    and (k+1)-th expert of a token, or the capacity between tokens equal up
    to rounding) turns on the last bits of the hidden state, which the two
    attention paths round differently; a plain path that replays the kernel
    path's plans then differs from it by the attention's rounding alone.
    Without experts nothing is recorded. Test tooling only."""
    moe_mod = importlib.import_module("repro_torch.nn.moe")
    route = moe_mod._route
    recorded = iter(list(plans))

    def planned(*args, **kw):
        if replay:
            return next(recorded)
        plan = route(*args, **kw)
        plans.append(plan)
        return plan

    moe_mod._route = planned
    try:
        yield
    finally:
        moe_mod._route = route
    check(not replay or next(recorded, None) is None, "moe_plans: a recorded plan unused")


def attention_layers(cfg) -> int:
    """Attention applications per forward or decode step: every layer, the
    shared block once per group of a hybrid, none in the xLSTM."""
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def moe_layers(cfg) -> int:
    """MoE layers per forward or decode step: every layer of a MoE model, or
    every ``moe_every``-th with the interleave."""
    if not cfg.n_experts:
        return 0
    return cfg.n_layers // cfg.moe_every if cfg.moe_every > 1 else cfg.n_layers


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
    """The registered serve2 pipeline's stage 1, served alone: bursty
    arrivals, seed 3, 120 s of virtual time, under the registered
    ``controller`` with seed 3."""
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


def logit_err(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """max |got - want|: absolute for f32 weights (LOGIT_TOL), relative to
    max(1, max |want|) for bf16 weights (TOL[bf16])."""
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= max(1.0, want.float().abs().max().item())
    return err


def held_in_f32(server, z: int, tokens, cfg) -> tuple[float, torch.Tensor]:
    """Variant ``z``'s weights widened to f32 in place on the card (each put
    back to its own dtype after: bf16 -> f32 -> bf16 is exact), through the
    kernel path and the plain attention path (replaying the kernel path's
    MoE plans): -> (max |kernel - plain| logits, the plain f32 logits)."""
    from repro_torch.models import api as model_api
    model, cfg32 = server.params[z], cfg.replace(dtype="float32")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    batch = server._make_batch(tokens, cfg32)
    plans = []
    model.float()
    try:
        with torch.inference_mode():
            with moe_plans(plans, replay=False):
                k32, _ = model_api.forward(model, batch, cfg32)
            with plain_attention(), moe_plans(plans, replay=True):
                p32, _ = model_api.forward(model, batch, cfg32)
    finally:
        for n, p in model.named_parameters():
            p.data = p.data.to(dtypes[n])
    return logit_err(k32, p32, torch.float32), p32


def serve_live(sess, virtual: dict, tag: str,
               all_variants: bool) -> tuple[dict, dict, list]:
    """``sess.serve()`` of a real session with every live stage's executor
    recorded. Checks: every request served, the virtual-time results equal
    ``virtual`` (the same spec with real=False), flash launches = Σ n_layers
    over the executed batches of attention variants, moe_combine launches =
    Σ MoE layers over the executed batches, no decode launch, every
    stage executed and each variant of it (``all_variants``), and the kernel
    path's logits against the plain attention path for each variant of each
    stage (on its first batch, or on the stage's first batch where the
    controller never chose it) and on the largest batch, the plain path
    replaying the kernel path's MoE dispatch plans (``moe_plans``), within
    LOGIT_TOL absolute for f32 weights and TOL[bf16] of max(1, max |plain
    logit|) for bf16 weights; every flash call of the kernel path within
    CALL_TOL of the plain version on its own inputs. With bf16 weights the
    library's attention (``library_attention``) runs the batch too: where it
    also misses TOL[bf16] against the plain path, bf16 logits cannot tell two
    correct attention paths apart on that model, and the variant's weights
    widened to f32 hold the kernel path instead (``held_in_f32``, LOGIT_TOL).
    Returns the report, the launch counts and the recorded batches (stage,
    variant, tokens, output tokens, wall s)."""
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
            secs = sum(w for st, v, *_, w in batches if (st, v) == (i, z))
            check(bool(sizes) or not all_variants,
                  f"{tag}: stage {i} variant {z} ({name}) never executed")
            print(f"{tag}: stage {i} {name}: {len(sizes)} batches"
                  + (f", sizes {min(sizes)}-{max(sizes)}, {sum(sizes)} requests, "
                     f"{secs:.3f} s inside execute ({secs / len(sizes) * 1e3:.3f} ms a batch)"
                     if sizes else " (never chosen)"), flush=True)
    exec_s = sum(b[-1] for b in batches)
    print(f"{tag}: serve wall {wall:.3f}s, inside execute {exec_s:.3f}s "
          f"({exec_s / wall:.4f} of it); {len(batches) / wall:.2f} batches/s, "
          f"{s['served'] / wall:.2f} req/s live through the pipeline; launches {counts}",
          flush=True)

    check(s["served"] == s["submitted"] > 0,
          f"{tag}: {s['served']} of {s['submitted']} requests served")
    for key in ("summary", "rewards", "configs"):
        check(rep[key] == virtual[key], f"{tag}: {key} differs from the real=False run")
    want = sum(attention_layers(servers[i].variants[z]) for i, z, *_ in batches)
    check(counts["flash_attention"] == want,
          f"{tag}: flash launches {counts['flash_attention']} != {want}")
    want = sum(moe_layers(servers[i].variants[z]) for i, z, *_ in batches)
    check(counts["moe_combine"] == want,
          f"{tag}: moe_combine launches {counts['moe_combine']} != {want}")
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
        dtype = cfg.param_dtype
        batch = server._make_batch(tokens, cfg)
        plans, calls = [], []
        with torch.inference_mode():
            with moe_plans(plans, replay=False), attention_held(calls):
                lk, _ = model_api.forward(server.params[z], batch, cfg)
            with plain_attention(), moe_plans(plans, replay=True):
                lp, _ = model_api.forward(server.params[z], batch, cfg)
        check(bool(torch.isfinite(lk).all()), f"{tag}: {cfg.name}: non-finite logits")
        err = logit_err(lk, lp, dtype)
        tol = TOL[dtype] if dtype == torch.bfloat16 else LOGIT_TOL
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
        call_err = max(calls, default=0.0)
        line = (f"{tag}: stage {i} batch {k} ({cfg.name}, {len(tokens)} requests) kernel vs "
                f"plain attention logits{' (MoE plans replayed)' if plans else ''} "
                f"max{' rel' if dtype == torch.bfloat16 else ''}|diff| {err:.3e} (tol {tol}), "
                f"argmax agreement {agree:.4f}; {len(calls)} flash calls each against the "
                f"plain version on its inputs: max rel|diff| {call_err:.3e} "
                f"(tol {CALL_TOL[dtype]:.4g})")
        if zk == z:
            same = float((lk.argmax(-1).cpu().numpy() == out).mean())
            line += f", served tokens reproduced {same:.4f}"
            check(same == 1.0, f"{tag}: {cfg.name}: served tokens not reproduced")
        check(call_err < CALL_TOL[dtype],
              f"{tag}: {cfg.name}: a flash call off its plain version by {call_err}")
        if dtype == torch.bfloat16:
            with torch.inference_mode(), library_attention(), moe_plans(plans, replay=True):
                ls, _ = model_api.forward(server.params[z], batch, cfg)
            lib = logit_err(ls, lp, dtype)
            line += f"; the library's attention (SDPA) vs plain {lib:.3e}"
            if lib >= tol:
                e32, p32 = held_in_f32(server, z, tokens, cfg)
                far = {n: logit_err(x, p32, dtype) for n, x in
                       (("kernel", lk), ("plain", lp), ("library", ls))}
                line += (f", so bf16 cannot part two correct attention paths on this model: "
                         f"held in f32 from the same weights, kernel vs plain max|diff| "
                         f"{e32:.3e} (tol {LOGIT_TOL}); each bf16 path's max rel|diff| from "
                         f"that f32 result: " + ", ".join(f"{n} {e:.3e}" for n, e in far.items()))
                print(line, flush=True)
                check(e32 < LOGIT_TOL, f"{tag}: {cfg.name}: f32 kernel path logits off by {e32}")
                continue
        print(line, flush=True)
        check(err < tol, f"{tag}: {cfg.name}: kernel path logits off by {err}")
    return rep, counts, batches


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


TIE_GAP = 1e-4              # a flipped greedy head's top-2 logit gap on the CPU copy


def near_tie_gaps(cpu_params, state, a, b) -> list[tuple[int, float]]:
    """(head, top-2 logit gap of the CPU copy at ``state``) for every head
    where the greedy actions ``a`` and ``b`` differ."""
    from repro_torch.core import policy

    a, b = np.asarray(a), np.asarray(b)
    if np.array_equal(a, b):
        return []
    with torch.no_grad():
        logits, _ = policy.apply_policy(cpu_params, torch.as_tensor(state)[None])
    gaps = []
    for h in np.flatnonzero(a != b):
        top = torch.topk(logits[h][0], 2).values
        gaps.append((int(h), (top[0] - top[1]).item()))
    return gaps


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
            ties += [(i, t_div, h, gap) for h, gap in near_tie_gaps(
                cpu_params, c_traj["states"][i, t_div], g_act[i, t_div], c_act[i, t_div])]
        compared += t_div
        if t_div:
            r_err = max(r_err, (g_traj["rewards"][i, :t_div].cpu()
                                - c_traj["rewards"][i, :t_div]).abs().max().item())
    print(f"opd: greedy vec_rollout of {len(envs)} envs x {n_steps} intervals, card vs "
          f"CPU: actions equal on {compared} of {len(envs) * n_steps} steps, near-tie "
          f"flips {ties}, rewards max abs err {r_err:.3e} (tol 1e-4)", flush=True)
    check(all(gap < TIE_GAP for *_, gap in ties), f"opd: greedy actions differ at {ties}")
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
    rep, counts, _ = serve_live(sess, virtual, "opd", all_variants=False)
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


FORECASTERS = ("lstm-multi", "mlstm-multi")


def forecast_spec(predictor: str | None, controller: str = "proactive-capacity",
                  real: bool = True):
    """The registered serve2 pipeline (both stages, f32 weights, the
    analytic perf model) under bursty arrivals at 25 req/s, seed 3, 120 s,
    with ``predictor`` attached and ``controller`` (seed 3) in the loop."""
    from dataclasses import replace

    from repro_torch import api
    return api.ExperimentSpec(
        pipeline=api.get_pipeline("serve2"),
        scenario=replace(api.get_scenario("bursty"), rate=25.0, seed=3, horizon=120,
                         predictor=predictor),
        controller=replace(api.get_controller(controller), seed=3),
        backend="runtime", real=real)


def held_out_traces(scen, ps, n: int = 2) -> list[np.ndarray]:
    """Traces the forecaster never trained on: the next ``n`` episodes of
    the scenario's ``train_trace``, Poisson-drawn as Session.build_forecaster
    draws its own."""
    out = []
    for ep in range(ps.train_episodes, ps.train_episodes + n):
        rng = np.random.default_rng(scen.seed + 104729 * (ep + 1))
        out.append(rng.poisson(np.maximum(scen.train_trace(ep), 0.0)).astype(np.float32))
    return out


def check_forecaster(name: str, fn, scen) -> None:
    """One trained forecaster: SMAPE and pinball per horizon on held-out
    traces, ``forecast_batch`` on the card against a CPU copy, and one
    training step from the same params and batch on both."""
    import copy

    from repro_torch import api
    from repro_torch.core import forecast
    from repro_torch.train import adamw_init

    ps = api.get_predictor(name)
    params = fn.params
    check(all(p.device.type == "cuda" for p in params.parameters()),
          f"forecast: {name} parameters not on the card")
    held = held_out_traces(scen, ps)
    kw = dict(backbone=ps.backbone, scale=fn.scale, horizons=ps.horizons,
              history=ps.history, n_heads=ps.n_heads, channel_scales=fn.channel_scales)
    smape = forecast.smape_horizons(params, held, **kw)
    pinball = forecast.pinball_horizons(params, held, **kw)
    print(f"forecast: {name} on held-out traces (2 x {len(held[0])} s, scale "
          f"{fn.scale}): SMAPE % per horizon "
          + ", ".join(f"{h}s {v:.3f}" for h, v in smape.items())
          + "; pinball(q=0.9) per horizon "
          + ", ".join(f"{h}s {v:.4f}" for h, v in pinball.items()), flush=True)
    check(all(np.isfinite(list(smape.values()) + list(pinball.values()))),
          f"forecast: {name} non-finite SMAPE or pinball")

    X, y, _ = forecast.make_forecast_dataset(held, history=ps.history, horizons=ps.horizons,
                                             scale=fn.scale,
                                             channel_scales=fn.channel_scales)
    xb = torch.as_tensor(X[:64])
    cpu = copy.deepcopy(params).cpu()
    with torch.no_grad():
        g = forecast.forecast_batch(params, xb.cuda(), backbone=ps.backbone,
                                    n_heads=ps.n_heads)
        c = forecast.forecast_batch(cpu, xb, backbone=ps.backbone, n_heads=ps.n_heads)
    b_err = rel_err(c, g)
    yb = torch.as_tensor(y[:64])
    g_p, g_o, g_l = forecast._train_step(copy.deepcopy(params), adamw_init(params),
                                         xb.cuda(), yb.cuda(), ps.lr,
                                         backbone=ps.backbone, n_heads=ps.n_heads)
    c_p, c_o, c_l = forecast._train_step(copy.deepcopy(cpu), adamw_init(cpu), xb, yb, ps.lr,
                                         backbone=ps.backbone, n_heads=ps.n_heads)
    p_err = max((c - g.cpu()).abs().max().item() for c, g in
                zip(c_p.parameters(), g_p.parameters(), strict=True))
    l_err = abs(g_l.item() - c_l.item()) / max(1.0, abs(c_l.item()))
    print(f"forecast: {name} card vs CPU: forecast_batch of 64 windows max rel err "
          f"{b_err:.3e} (tol 1e-5); one training step: params max abs err {p_err:.3e} "
          f"(tol 1e-4), loss rel err {l_err:.3e} (tol 1e-5)", flush=True)
    check(b_err < 1e-5, f"forecast: {name} forecast_batch card vs CPU off by {b_err}")
    check(p_err < 1e-4, f"forecast: {name} training step params card vs CPU off by {p_err}")
    check(l_err < 1e-5, f"forecast: {name} training step loss card vs CPU off by {l_err}")


def phase_forecast() -> dict:
    """Load forecasting, proactive pre-warm control and the fleet on the
    card: both registered multi-horizon forecasters trained there and held
    against the CPU, serve2 served live under proactive-capacity, the
    proactive OPD controller trained there, and the registered fleet served
    with and without a forecasting tenant."""
    from dataclasses import replace

    from repro_torch import api

    # -- train both forecasters on the card, as a Session builds them
    fns = {}
    for name in FORECASTERS:
        sess = api.Session(forecast_spec(name), device="cuda")
        lines = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name] = sess.build_forecaster(log=lines.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ps = api.get_predictor(name)
        print(f"forecast: {name} ({ps.backbone}, horizons {ps.horizons}, "
              f"{sum(p.numel() for p in fns[name].params.parameters())} parameters) "
              f"trained on the card in {wall:.3f} s: " + "; ".join(lines), flush=True)
        check(len(lines) == ps.epochs, f"forecast: {name} logged {len(lines)} epochs")
        check_forecaster(name, fns[name], sess.spec.scenario)
        # the same training again, to report whether the card repeats it
        again = api.Session(forecast_spec(name), device="cuda").build_forecaster()
        diff = max((a - b).abs().max().item() for a, b in zip(
            fns[name].params.parameters(), again.params.parameters(), strict=True))
        print(f"forecast: {name} trained twice with the same seed: params max abs "
              f"diff {diff:.3e} ({'equal' if diff == 0 else 'not equal'}; reported only)",
              flush=True)
        del again

    # -- proactive-capacity over serve2, both stages live, lstm-multi on the card
    fn = fns["lstm-multi"]
    hist = np.random.default_rng(0).poisson(25.0, 120).astype(np.float64)
    fc_ms = [synced_ms(lambda: fn(hist)) for _ in range(12)][2:]
    print(f"forecast: one lstm-multi call (120 s window to the card, [4] back) median "
          f"{float(np.median(fc_ms)):.3f} ms, min {min(fc_ms):.3f} ms over {len(fc_ms)} "
          f"synchronised calls", flush=True)
    spec = forecast_spec("lstm-multi")
    live = api.Session(spec, device="cuda")
    virt = api.Session(replace(spec, real=False), device="cuda")
    # one trained forecaster for both, so the virtual-time gate compares the
    # executors alone
    live._forecaster = virt._forecaster = fn
    virtual = virt.serve()
    t0 = time.perf_counter()
    rep, counts, _ = serve_live(live, virtual, "forecast", all_variants=False)
    wall = time.perf_counter() - t0
    s = rep["summary"]
    dts = np.asarray(rep["decide_wall_s"]) * 1e3
    print(f"forecast: proactive-capacity live serve of serve2: {s['served']}/"
          f"{s['submitted']} served, prewarms {s['prewarms']}, switches {s['switches']}, "
          f"plans published {live.controller.planned}; p50 {s['p50']:.6f} s, p99 "
          f"{s['p99']:.6f} s (virtual); decision d_t with the forecaster on the card over "
          f"{len(dts)} decisions: median {float(np.median(dts)):.3f} ms, max "
          f"{float(dts.max()):.3f} ms; flash launches {counts['flash_attention']}; "
          f"phase wall {wall:.3f} s", flush=True)
    check(s["prewarms"] > 0, "forecast: the proactive serve pre-warmed nothing")
    del live, rep
    gc.collect()
    torch.cuda.empty_cache()

    # -- the proactive OPD controller trained on the card, served in virtual time
    pspec = replace(forecast_spec("lstm-multi", "proactive", real=False),
                    controller=replace(api.get_controller("proactive"), seed=3,
                                       train_episodes=2, num_envs=4))
    sess = api.Session(pspec, device="cuda")
    sess._forecaster = fn
    t0 = time.perf_counter()
    sess.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    params = sess.trainer.params
    check(all(p.device.type == "cuda" for p in params.parameters()),
          "forecast: proactive policy parameters not on the card")
    vs = sess.serve()["summary"]
    print(f"forecast: proactive trained on the card ({sess.trainer.num_envs} envs, "
          f"rewards {[round(r, 2) for r in sess.trainer.history['reward']]}) in "
          f"{train_s:.3f} s; served 120 s (real=False): {vs['served']}/{vs['submitted']}, "
          f"prewarms {vs['prewarms']}, plans {sess.controller.planned}", flush=True)
    check(vs["served"] == vs["submitted"] > 0,
          f"forecast: proactive served {vs['served']} of {vs['submitted']}")

    # -- the registered fleet, and a copy whose interactive tenant forecasts
    fleet = api.get_fleet("fleet-3tenant-hetero")
    pro = tuple(replace(t, controller=replace(api.get_controller("proactive-capacity"),
                                              seed=3),
                        scenario=replace(t.scenario, predictor="lstm-multi"))
                if t.name == "interactive" else t for t in fleet.tenants)
    for tag, fspec in (("fleet", fleet),
                       ("fleet-forecast", replace(fleet, name=f"{fleet.name}-forecast",
                                                  tenants=pro))):
        t0 = time.perf_counter()
        fsess = api.FleetSession(fspec, device="cuda")
        frep = fsess.serve()
        wall = time.perf_counter() - t0
        f = frep["summary"]["fleet"]
        print(f"{tag}: {fspec.name}: {f['served']}/{f['offered']} served, shed "
              f"{f['shed']}, {f['events']} events, {f['reallocations']} reallocations, "
              f"wall {wall:.3f} s (forecaster training included)", flush=True)
        for name, t in frep["summary"]["tenants"].items():
            print(f"{tag}: tenant {name} prio {t['priority']} share {t['share']:.4f} "
                  f"offered {t['arrived']} served {t['served']} shed {t['shed']} "
                  f"({t['shed_rate'] * 100:.2f}%) p50 {t['p50']} p95 {t['p95']} "
                  f"p99 {t['p99']} prewarms {t['prewarms']}"
                  + (f" slo_p99 {t['slo_p99']} met {t['slo_p99_met']}" if "slo_p99" in t
                     else ""), flush=True)
            check(t["arrived"] == t["served"] + t["shed"],
                  f"{tag}: tenant {name} offered {t['arrived']} != served {t['served']} "
                  f"+ shed {t['shed']}")
        fcs = [tn for tn in fsess.fleet.tenants if tn.env.forecaster is not None]
        check(len(fcs) == (1 if tag == "fleet-forecast" else 0),
              f"{tag}: {len(fcs)} tenants carry a forecaster")
        for tn in fcs:
            check(all(p.device.type == "cuda" for p in tn.env.forecaster.params.parameters()),
                  f"{tag}: tenant {tn.name}'s forecaster is not on the card")
    return counts


def fill_cache(cache: dict, gen) -> None:
    """Random self-attention KV in place (and a hybrid's SSM state and conv
    tails), and a different number of valid slots per row (17, 22, 27, 32,
    5, ... of C = 32): the step's attention then depends on q, which it
    does not over the grid's one valid slot."""
    C = cache["k"].shape[2]                          # [L, B, C, kv, hd]
    for name in ("k", "v", "ssm", "conv"):
        if name not in cache:
            continue
        t = cache[name]
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
    cache["pos"].copy_((torch.arange(len(cache["pos"]), device="cuda") * 5 + 16) % C)


def graph_checks(ex, phase: str = "calibrate") -> None:
    """Every captured step of the grid, replayed, against the same step run
    eagerly (the same kernels: equal) and run eagerly on the plain attention
    path (the kernels against their plain versions inside full-depth bf16
    and int8 steps, within bf16 rounding: TOL[bf16] of max(1, max |logit|);
    a MoE's plain step replays the eager step's dispatch plans, moe_plans).
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
            plans = []
            with moe_plans(plans, replay=False):
                eager = entry.eager()[0].float()
            with plain_attention(), moe_plans(plans, replay=True):
                plain = entry.eager()[0].float()
            scale = max(1.0, plain.abs().max().item())
            errs = ((graph - eager).abs().max().item() / scale,
                    (graph - plain).abs().max().item() / scale)
            tag = f"{key.arch}:{key.quant} b{key.batch} {state}"
            check(bool(torch.isfinite(graph).all()), f"{phase}: {tag}: non-finite logits")
            check(errs[0] < tol and errs[1] < tol,
                  f"{phase}: {tag}: graph logits off the eager step's by {errs[0]}, "
                  f"off the plain attention path's by {errs[1]}")
            w = worst.setdefault((key.arch, key.quant, state), [0.0, 0.0, []])
            w[0], w[1] = max(w[0], errs[0]), max(w[1], errs[1])
            w[2].append(key.batch)
    for (arch, quant, state), (e_eager, e_plain, batches) in worst.items():
        print(f"{phase}: {arch}:{quant} {state} state, b = {sorted(batches)}: graph vs "
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
        want = attention_layers(cfg)
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
    # stage1_spec's scenario, cut from 120 s to 20 s to keep the whole
    # script within two thirds of its limit, under the capacity controller
    spec = api.ExperimentSpec(
        pipeline=replace(api.get_pipeline("serve2"), perf_source="calibrated",
                         calibration="h100-serve2"),
        scenario=replace(api.get_scenario("bursty"), seed=3, horizon=20),
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
    rep, loop_counts, _ = serve_live(api.Session(spec, device="cuda"), virtual, "calibrate",
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
    _, cycle_counts, _ = serve_live(api.Session(cycle, device="cuda"), virtual,
                                    "calibrate-random", all_variants=True)
    return {k: grid_counts[k] + loop_counts[k] + cycle_counts[k] for k in grid_counts}


# greedy 20 s of the 30 s it ran through PR 23, to keep the script under 1100 s
FAMILY_SERVE = (("greedy", 3, 20, False), ("random", 2, 30, True))  # controller, seed, horizon,
                                                                    # every variant executed
GRAPH_ARCHS = ("granite-moe-3b-a800m", "zamba2-2.7b")
BF16_ARCHS = ("granite-3-8b", "llava-next-mistral-7b")   # paper-4stage's stage 3
BF16_DECODE_STEPS = 8


def weights_gib(models) -> float:
    return sum(p.numel() * p.element_size() for m in models for p in m.parameters()) / 2**30


def held_rel(kernel: torch.Tensor, plain: torch.Tensor, what: str) -> float:
    """max |kernel - plain| over max(1, max |plain|), checked against
    TOL[bf16]: bf16 rounding through a full-depth model (as graph_checks)."""
    err = ((kernel.float() - plain.float()).abs().max() / max(
        1.0, plain.float().abs().max().item())).item()
    check(bool(torch.isfinite(kernel.float()).all()), f"families: {what}: non-finite")
    check(err < TOL[torch.bfloat16], f"families: {what}: kernel path off the plain "
          f"attention path by {err} (rel)")
    return err


def launched(counts: dict, fn, *args):
    """``fn(*args)``, adding the kernel launches it made to ``counts``."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn(*args)
    after = ops.launch_counts()
    for k in counts:
        counts[k] += after[k] - before[k]
    return out


def bf16_stage() -> dict:
    """paper-4stage's stage 3 at full width in bf16, through ArchConfig.dtype:
    one StageServer over granite-3-8b and llava-next-mistral-7b. Each
    variant: a prefill through make_prefill_step (B = 1; llava's S = 576
    patches + 32 tokens), then BF16_DECODE_STEPS decode steps through
    make_serve_step from that cache, greedy on the kernel path, the plain
    path fed the same tokens. (Their execute, the forward a live stage runs,
    is held in the paper4 phase's serve.) Returns the launches of the
    driven calls (prefill, decode), not of the comparisons."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import api as model_api
    from repro_torch.models import steps
    from repro_torch.models.config import InputShape
    from repro_torch.serving import StageServer

    variants = [ARCHS[n].replace(dtype="bfloat16") for n in BF16_ARCHS]
    t0 = time.perf_counter()
    server = StageServer("stage3-bf16", variants, seq_len=32, device="cuda")
    torch.cuda.synchronize()
    print(f"families: built {list(BF16_ARCHS)} at full width in bf16 in "
          f"{time.perf_counter() - t0:.1f}s: {weights_gib(server.params):.2f} GiB of "
          f"weights", flush=True)
    rng = np.random.default_rng(18)
    counts = {"flash_attention": 0, "decode_attention": 0, "moe_combine": 0}
    for z, cfg in enumerate(variants):
        model = server.params[z]
        # prefill, then decode from its cache
        toks = rng.integers(0, cfg.vocab, (1, 32)).astype(np.int32)
        batch = server._make_batch(toks, cfg)
        S = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
        prefill = steps.make_prefill_step(cfg)
        with torch.inference_mode():
            last_k, pre = launched(counts, prefill, model, batch)
            with plain_attention():
                last_p, pre_p = prefill(model, batch)
        check(pre["k"].shape[2] == S and pre["pos"].tolist() == [S],
              f"families: {cfg.name} prefill cache {tuple(pre['k'].shape)}, pos "
              f"{pre['pos'].tolist()}")
        e_last = held_rel(last_k, last_p, f"{cfg.name} prefill logits")
        e_kv = max(held_rel(pre[n], pre_p[n], f"{cfg.name} prefill {n}") for n in ("k", "v"))
        C = 64 * -(-(S + BF16_DECODE_STEPS) // 64)
        shape = InputShape(f"decode_c{C}", C, 1, "decode")
        serve_step = steps.make_serve_step(cfg, shape)
        caches = []
        for _ in range(2):
            cache = model_api.init_cache(cfg, 1, C, device="cuda")
            cache["k"][:, :, :S], cache["v"][:, :, :S] = pre["k"], pre["v"]
            cache["pos"].copy_(pre["pos"])
            caches.append(cache)
        tok = last_k.argmax(-1, keepdim=True)
        e_dec, step_s = 0.0, []
        before = counts["decode_attention"]
        for i in range(BF16_DECODE_STEPS):
            with torch.inference_mode():
                t = time.perf_counter()
                lk, caches[0] = launched(counts, serve_step, model, {"tokens": tok},
                                         caches[0])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                with plain_attention():
                    lp, caches[1] = serve_step(model, {"tokens": tok}, caches[1])
            e_dec = max(e_dec, held_rel(lk, lp, f"{cfg.name} decode step {i}"))
            tok = lk[:, -1].argmax(-1, keepdim=True)
        n_dec = counts["decode_attention"] - before
        check(n_dec == BF16_DECODE_STEPS * cfg.n_layers,
              f"families: {cfg.name}: {n_dec} decode launches")
        check(caches[0]["pos"].tolist() == [S + BF16_DECODE_STEPS],
              f"families: {cfg.name}: pos {caches[0]['pos'].tolist()} after decode")
        print(f"families: {cfg.name} bf16 prefill B1 S{S}: last logits vs plain max rel "
              f"diff {e_last:.3e}, k/v cache {e_kv:.3e}; {BF16_DECODE_STEPS} decode steps "
              f"over C = {C} (eager, synchronised ms {[round(x * 1e3, 3) for x in step_s]}): "
              f"logits vs plain max rel diff {e_dec:.3e} (tol {TOL[torch.bfloat16]}); "
              f"{n_dec} decode launches", flush=True)
    return counts


def phase_families() -> dict:
    """serve3's stage 2 families (granite-moe, zamba2) and paper-4stage's
    stage 3 (granite-3-8b, llava) on the card: the registered serve3 served
    live at full width in f32 under greedy (20 s) and random (30 s; random runs
    every variant of every stage live) with the runtime phase's checks; the two
    stage-3 archs at full width in bf16 (bf16_stage); graph-captured decode
    steps of granite-moe and zamba2 in bf16 and int8 at b = 1 and 32, held
    against their eager steps and the plain attention path."""
    from dataclasses import replace

    from repro_torch import api
    from repro_torch.cluster import executor

    counts = {"flash_attention": 0, "decode_attention": 0, "moe_combine": 0}
    for controller, seed, horizon, every in FAMILY_SERVE:
        spec = api.ExperimentSpec(
            pipeline=api.get_pipeline("serve3"),
            scenario=replace(api.get_scenario("bursty"), seed=3, horizon=horizon),
            controller=replace(api.get_controller(controller), seed=seed),
            backend="runtime", real=True)
        virtual = api.Session(replace(spec, real=False)).serve()
        sess = api.Session(spec, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        rep, c, _ = serve_live(sess, virtual, f"families-serve3-{controller}",
                               all_variants=every)
        s = rep["summary"]
        print(f"families: serve3 {controller} {horizon} s: {s['served']}/{s['submitted']} "
              f"served live at full width in f32, {weights_gib(m for srv in sess.servers for m in srv.params):.2f} "
              f"GiB of weights, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; virtual p50 "
              f"{s['p50']:.6f} s, p99 {s['p99']:.6f} s", flush=True)
        for k in counts:
            counts[k] += c[k]
        del sess, rep
        gc.collect()
        torch.cuda.empty_cache()

    for k, n in bf16_stage().items():
        counts[k] += n
    gc.collect()
    torch.cuda.empty_cache()

    ex = executor.StageExecutor("cuda", seq_len=32)
    for arch in GRAPH_ARCHS:
        cfg = ex.arch_config(arch)
        for quant in ("bf16", "int8"):
            for b in (1, 32):
                t = launched(counts, ex.measure, arch, b, quant)
                check(t.launches == {"flash_attention": 0,
                                     "decode_attention": attention_layers(cfg),
                                     "moe_combine": moe_layers(cfg)},
                      f"families: {arch}:{quant} b{b} captured launches {t.launches}")
                print(f"families: {arch}:{quant} b{b}: graph replay {t.latency_s * 1e3:.4f} "
                      f"ms, eager {t.eager_latency_s * 1e3:.4f} ms (min of 5), capture "
                      f"{t.compile_s:.3f} s, launches per step {t.launches}, "
                      f"{t.bytes / 1e9:.4f} GB and {t.flops / 1e9:.3f} GFLOP a step, "
                      f"bound {t.bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)", flush=True)
    for arch in GRAPH_ARCHS:
        for b in (1, 32):
            entry, _ = ex.compiled_step(arch, b, "bf16")
            profiled(f"{arch}:bf16 b{b} graph replay", entry.replay, "families")
            profiled(f"{arch}:bf16 b{b} eager step", entry.eager, "families")
    del entry
    graph_checks(ex, "families")
    del ex
    return counts


# 40 s of the 60 s it ran through PR 23 (the same decisions and arrivals up to 40 s;
# every variant of every stage still runs), to keep the script under 1100 s
PAPER4 = ("paper-4stage", "bursty", 3, 40, "random", 2)   # pipeline, arrivals, seed,
                                                          # horizon (s), controller, seed


def phase_paper4() -> dict:
    """The registered paper-4stage served live at full width in bf16
    (Session(..., dtype="bfloat16"): its eight archs, about 50.5 GiB) under
    the random controller, which executes every variant of every stage, with
    the runtime phase's checks at TOL[bf16] relative (MoE plans replayed);
    then the flash kernel timed at the live serve's largest batch."""
    from dataclasses import replace

    from repro_torch import api

    name, kind, seed, horizon, controller, cseed = PAPER4
    spec = api.ExperimentSpec(
        pipeline=api.get_pipeline(name),
        scenario=replace(api.get_scenario(kind), seed=seed, horizon=horizon),
        controller=replace(api.get_controller(controller), seed=cseed),
        backend="runtime", real=True)
    virtual = api.Session(replace(spec, real=False)).serve()
    sess = api.Session(spec, device="cuda", dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep, counts, batches = serve_live(sess, virtual, "paper4", all_variants=True)
    wall = time.perf_counter() - t0
    s = rep["summary"]
    check(s["served"] + s.get("shed", 0) == s["submitted"],
          f"paper4: served {s['served']} + shed {s.get('shed', 0)} != offered "
          f"{s['submitted']}")
    params = [m for srv in sess.servers for m in srv.params]
    check(all(m.embed.e.dtype == torch.bfloat16 for m in params),
          "paper4: an embedding table is not bf16")
    exec_s = sum(b[-1] for b in batches)
    print(f"paper4: {name} {kind} {horizon} s ({controller}, seed {cseed}): "
          f"{s['served']}/{s['submitted']} served live at full width in bf16, "
          f"{weights_gib(params):.2f} GiB of weights, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (build, serve and checks); "
          f"{len(batches)} live batches in {wall:.3f} s wall (with the checks): "
          f"executor share {exec_s / wall:.4f}; virtual p50 {s['p50']:.6f} s, "
          f"p99 {s['p99']:.6f} s", flush=True)
    for i, server in enumerate(sess.servers):
        for z, cfg in enumerate(server.variants):
            mine = [b for b in batches if b[:2] == (i, z)]
            print(f"paper4: stage {i} {cfg.name} bf16: {len(mine)} batches, "
                  f"{sum(len(b[2]) for b in mine)} requests, "
                  f"{sum(b[-1] for b in mine) / max(len(mine), 1) * 1e3:.3f} ms a batch "
                  f"(sizes {min(len(b[2]) for b in mine)}-{max(len(b[2]) for b in mine)})",
                  flush=True)
    # the flash kernel at the largest batch an attention variant ran
    i, z, tokens = max(((b[0], b[1], b[2]) for b in batches
                        if attention_layers(sess.servers[b[0]].variants[b[1]])),
                       key=lambda b: len(b[2]))
    cfg = sess.servers[i].variants[z]
    S = tokens.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    shape = (len(tokens), S, cfg.n_heads, cfg.n_kv, cfg.head_dim)
    del sess, rep
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    row, ok = flash_case(Timer(), gen, shape, torch.bfloat16, timed=True)
    row["at"] = f"paper4's largest live batch ({cfg.name})"
    print("case " + json.dumps(row), flush=True)
    check(ok, f"paper4: flash at {shape} disagrees with the plain version")
    return counts


DRYRUN_MEASURE = 3          # records that fit, run on the card (decode shapes first)
DRYRUN_OUT = "chiprun_out/dryrun"
DRYRUN_LOG = os.path.join(DRYRUN_OUT, "count.log")
DRYRUN_PEAK_SLACK = 1.25    # measured peak <= counted peak + 25%


def start_dryrun_count():
    """Start launch/dryrun.py's count of every record on the host's CPU (its
    steps in worker processes) -> (the process, its start time)."""
    os.makedirs(DRYRUN_OUT, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    with open(DRYRUN_LOG, "w") as log:          # a file: nobody reads a pipe meanwhile
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--measure", "0",
             "--device", "cpu", "--out", DRYRUN_OUT],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)                 # its workers die with it
    return proc, time.perf_counter()


def stop(proc) -> None:
    """Kill ``proc`` and its process group if it still runs."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def phase_dryrun(count=None) -> dict:
    """launch/dryrun.py: every (arch, INPUT_SHAPES) record counted on fake
    tensors by the launcher on the host's CPU (its steps in worker
    processes; ``count``, from start_dryrun_count, when a whole run started
    it beside the twin, train, figures, mesh and mesh_train phases; else
    started here), then up to DRYRUN_MEASURE records that fit run on the card.
    Gates: every record has a status, counted flops > 0 where OK,
    measured peak <= the counted peak + 25%."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models.config import INPUT_SHAPES

    counting, t0 = count or start_dryrun_count()
    try:
        counting.wait(timeout=900)
    finally:
        stop(counting)
    with open(DRYRUN_LOG) as fh:
        log = fh.read()
    for line in log.splitlines():
        if not line.startswith("E1"):
            print(f"dryrun: {line.rstrip()}", flush=True)
    check(counting.returncode == 0, f"dryrun: the count exited with {counting.returncode}")
    print(f"dryrun: counted in {time.perf_counter() - t0:.1f} s on {os.cpu_count()} host "
          f"cores (from its start)", flush=True)
    records = []
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            with open(os.path.join(DRYRUN_OUT, f"{arch}_{shape}_1x1.json")) as fh:
                records.append(json.load(fh))
    statuses = {r["status"] for r in records}
    check(len(records) == len(ARCHS) * len(INPUT_SHAPES) and statuses <= {
        "OK", "DOES_NOT_FIT", "SKIP"}, f"dryrun: statuses {statuses}")
    check(all(r["flops_per_device"] > 0 for r in records if r["status"] == "OK"),
          "dryrun: an OK record counted no flops")
    print(f"dryrun: {len(records)} records: " + ", ".join(
        f"{st} {sum(r['status'] == st for r in records)}" for st in sorted(statuses)),
        flush=True)
    chosen = dryrun.pick(records, DRYRUN_MEASURE)
    check(any(INPUT_SHAPES[r["shape"]].kind == "decode" for r in chosen),
          "dryrun: no decode record fits the card")
    ops.reset_launch_counts()
    for rec in chosen:
        rec["measured"] = m = dryrun.measure(rec, device="cuda")
        print(f"dryrun: measured {rec['arch']} {rec['shape']}: {m['ms']:.4f} ms a step "
              f"(min of {m['reps']}), first {m['first_step_ms']:.1f} ms; peak "
              f"{m['peak_bytes'] / 1e9:.3f} GB vs counted {rec['peak_bytes'] / 1e9:.3f} GB "
              f"(ratio {m['peak_over_counted']:.4f}); bound "
              f"{rec['roofline']['bound_s'] * 1e3:.4f} ms ({rec['roofline']['dominant']}), "
              f"share {m['share_of_bound']:.4f}", flush=True)
        check(m["peak_over_counted"] <= DRYRUN_PEAK_SLACK,
              f"dryrun: {rec['arch']} {rec['shape']}: measured peak {m['peak_bytes']} over "
              f"the counted {rec['peak_bytes']} + 25%")
        gc.collect()
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    dryrun.write(chosen, DRYRUN_OUT)
    return counts


TWIN_SPEC = ("serve3-hetero", "bursty", 25.0)       # pipeline, arrivals, rate (req/s)
EAGER_STEPS = 4             # intervals of the eager replay held against the captured one


def phase_twin() -> dict:
    """The discrete-event runtime twin on the card: Session.train of the
    registered opd controller with train_backend="runtime" (serve3-hetero,
    bursty at 25 req/s, 8 envs, 2 episodes), one fixed action sequence
    replayed through the twin on the card (captured blocks and eager), on
    the CPU and through the NumPy RuntimeEnv, and the three num_envs points
    of launch/runtime_train_throughput.py. Launches no attention kernel."""
    from dataclasses import replace

    from repro_torch import api
    from repro_torch.analysis import sanitize
    from repro_torch.cluster import RuntimeEnv
    from repro_torch.core import policy, vecenv
    from repro_torch.core import runtime_vec as rv
    from repro_torch.core.mdp import QoSWeights
    from repro_torch.launch import runtime_train_throughput as rtt
    from repro_torch.serving import make_arrivals

    name, kind, rate = TWIN_SPEC
    spec = api.ExperimentSpec(
        pipeline=api.get_pipeline(name),
        scenario=replace(api.get_scenario(kind), rate=rate, seed=3, horizon=120),
        controller=replace(api.get_controller("opd"), seed=3, train_episodes=2, num_envs=8,
                           train_backend="runtime"),
        backend="runtime")
    sess = api.Session(spec, device="cuda")
    stamps = [time.perf_counter()]

    def log(msg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        print(f"twin: {msg} ({(stamps[-1] - stamps[-2]) * 1e3:.1f} ms)", flush=True)

    sess.train(log=log)
    tr = sess.trainer
    hist = tr.history
    check(tr._vec_runtime is not None and tr._tables.accuracy.is_cuda,
          "twin: the trainer did not take the runtime twin on the card")
    check(hist["expert"] == [False, True], f"twin: expert episodes {hist['expert']}")
    check(all(np.isfinite(hist[k]).all() for k in ("reward", "loss", "value_loss")),
          "twin: non-finite training history")
    check(all(p.is_cuda for p in tr.params.parameters()), "twin: policy not on the card")
    print(f"twin: Session.train opd train_backend=runtime on {name}, {kind} {rate} req/s, "
          f"{tr.num_envs} envs: episode ms "
          f"{[round((b - a) * 1e3, 1) for a, b in zip(stamps, stamps[1:])]} "
          f"(episode 1 on the twin, 2 expert on RuntimeEnv), rewards "
          f"{[round(r, 4) for r in hist['reward']]}", flush=True)

    # -- one fixed action sequence: the card (captured, eager), the CPU, RuntimeEnv
    pipe = api.get_pipeline(name).build()
    n_steps = 12
    rng = np.random.default_rng(5)
    sizes = policy.head_sizes(pipe)
    actions = np.stack([[rng.integers(0, s) for s in sizes]
                        for _ in range(n_steps)]).astype(np.int32)
    ep = rv.episode_arrivals(make_arrivals(kind, rate=rate, seed=7), 120)
    w = QoSWeights()
    outs = {}
    # the eager loop replays the first EAGER_STEPS intervals only (a
    # replay's first k intervals do not depend on the later ones)
    for tag, dev, capture, steps in (("graph", "cuda", True, n_steps),
                                     ("eager", "cuda", False, EAGER_STEPS),
                                     ("cpu", "cpu", False, n_steps)):
        tables = vecenv.tables_from_pipeline(pipe, device=dev)
        t = time.perf_counter()
        out = rv.replay(tables, ep, torch.from_numpy(actions), n_steps=steps, weights=w,
                        capture=capture)
        if dev == "cuda":
            torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t) * 1e3
        outs[tag] = {k: v.cpu() for k, v in out.items()}
        print(f"twin: replay of {steps} intervals on {tag}: {replay_ms:.1f} ms", flush=True)
    env = RuntimeEnv(pipe, make_arrivals(kind, rate=rate, seed=7), horizon=120)
    ref_r, ref_c = [], []
    for a in actions:
        _, r, _, info = env.step(policy.action_to_config(pipe, a))
        ref_r.append(float(r))
        ref_c.append(int(info["processed"]))
    ref_r, ref_c = np.asarray(ref_r), np.asarray(ref_c)
    g, c = outs["graph"], outs["cpu"]
    same_eager = all(torch.equal(g[k][:EAGER_STEPS], outs["eager"][k]) for k in g)
    r_err = rel_err(c["rewards"], g["rewards"])
    env_c = int(np.abs(g["completed"].numpy() - ref_c).max())
    env_r = float(np.abs(g["rewards"].numpy() - ref_r).max())
    print(f"twin: served per interval card {g['completed'].int().tolist()}, CPU "
          f"{c['completed'].int().tolist()}, RuntimeEnv {ref_c.tolist()}; rewards card vs "
          f"CPU max rel err {r_err:.3e} (tol 1e-5); captured == eager bit for bit over "
          f"{EAGER_STEPS} intervals: {same_eager}; card vs RuntimeEnv: served max diff "
          f"{env_c} (tol 2), rewards max abs err {env_r:.3e} (tol 0.15)", flush=True)
    check(torch.equal(g["completed"], c["completed"]), "twin: served counts card != CPU")
    check(r_err < 1e-5, f"twin: rewards card vs CPU off by {r_err}")
    check(same_eager, "twin: captured blocks differ from the eager loop")
    check(env_c <= 2 and env_r < 0.15, "twin: card twin vs RuntimeEnv outside the bounds")

    # -- the sanitizer on the card: a replay under it runs the eager loop with
    # every op checked and equals the captured replay; a NaN planted in the
    # latency coefficient of the first chosen variant raises only under it
    tables = vecenv.tables_from_pipeline(pipe, device="cuda")
    t = time.perf_counter()
    with sanitize.enabled_scope():
        san = rv.replay(tables, ep, torch.from_numpy(actions), n_steps=EAGER_STEPS, weights=w)
    torch.cuda.synchronize()
    san_s = time.perf_counter() - t
    san = {k: v.cpu() for k, v in san.items()}
    san_same = torch.equal(san["completed"], g["completed"][:EAGER_STEPS])
    san_err = rel_err(g["rewards"][:EAGER_STEPS], san["rewards"])
    z0 = int(actions[0][0]) % int(tables.n_variants[0])
    alpha = tables.alpha.clone()
    alpha[0, z0] = float("nan")
    planted = tables._replace(alpha=alpha)
    quiet = rv.replay(planted, ep, torch.from_numpy(actions), n_steps=EAGER_STEPS, weights=w)
    quiet_nan = bool(torch.isnan(quiet["rewards"]).any())
    try:
        with sanitize.enabled_scope():
            rv.replay(planted, ep, torch.from_numpy(actions), n_steps=EAGER_STEPS, weights=w)
        raised = None
    except sanitize.SanitizerError as e:
        raised = str(e)
    print(f"twin: sanitized replay of {EAGER_STEPS} intervals on the card in {san_s:.1f} s: "
          f"served {san['completed'].int().tolist()} (captured equal: {san_same}), rewards "
          f"vs captured max rel err {san_err:.3e} (tol 1e-5); NaN planted in alpha[0, {z0}]: "
          f"unsanitized replay returned (NaN in its rewards: {quiet_nan}), sanitized "
          f"raised: {raised!r}", flush=True)
    check(san_same and san_err < 1e-5, "twin: the sanitized replay differs from the captured one")
    check(raised is not None and "nan" in raised, "twin: the planted NaN did not raise")

    # -- throughput at 1, 8 and 32 envs against the RuntimeEnv loop
    # captured blocks only: the eager loop's times come from the launcher's
    # own run (its replay above is held against the captured one)
    payload = rtt.run("cuda", horizon=120, reps=2, eager_reps=0, legacy_eps=2,
                      log=lambda m: print(m, flush=True))
    os.makedirs("chiprun_out/twin", exist_ok=True)
    with open("chiprun_out/twin/runtime_train_throughput.json", "w") as fh:
        json.dump(payload, fh, indent=1, default=float)
    return {"flash_attention": 0, "decode_attention": 0}


# the same run before cfg.remat was honoured (my chip runs, PR 19; H100 80GB HBM3, 700 W)
PR19_TRAIN = "891-899 ms a step, 4,566-4,597 tokens/s, peak 49.14-50.14 GiB"
TRAIN_ARGS = ["--arch", "llama3.2-1b", "--full", "--batch", "4", "--seq-len", "1024",
              "--lr", "3e-4", "--device", "cuda"]
SDPA_BACKWARD = ("BmmBackward0", "SoftmaxBackward0", "MaskedFillBackward0", "DivBackward0")


def sdpa_share(fn) -> str:
    """One call of ``fn`` (a train step) under torch.profiler with
    ``nn.attention._sdpa`` in a record_function range: the share of the
    device time in that range (the forward) and in the backward of its
    ops (bmm, softmax, masked_fill, div autograd nodes)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.nn import attention
    plain = attention._sdpa

    def ranged(*a, **k):
        with record_function("_sdpa"):
            return plain(*a, **k)

    attention._sdpa = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        attention._sdpa = plain
    ev = prof.key_averages()
    # the kernels' own events: an op's self device time repeats its kernels'
    total = sum(e.self_device_time_total for e in ev if e.device_type.name == "CUDA") / 1e3
    fwd = sum(e.device_time_total for e in ev if e.key == "_sdpa") / 1e3
    bwd = {n: sum(e.device_time_total for e in ev
                  if e.key == f"autograd::engine::evaluate_function: {n}") / 1e3
           for n in SDPA_BACKWARD}
    if total <= 0:
        return "not measured (no device time in the trace)"
    kernels = sorted((e for e in ev if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
                    for e in kernels[:5])
    return (f"step wall {wall * 1e3:.1f} ms (profiler on), device {total:.1f} ms in "
            f"{sum(e.count for e in kernels)} kernels (top: {top}); _sdpa "
            f"forward {fwd:.1f} ms ({fwd / total:.3f}), its backward nodes "
            + ", ".join(f"{n} {t:.1f}" for n, t in bwd.items())
            + f" ms ({sum(bwd.values()) / total:.3f}); share "
            f"{(fwd + sum(bwd.values())) / total:.3f}")


def phase_train() -> dict:
    """The LM train step on the card: launch/train.py with llama3.2-1b at
    published width and depth (f32, batch 4, seq 1024, lr 3e-4, 3 steps),
    then one step with --microbatch 2 from the same weights; the card
    against the CPU at full width and 2 layers with weights carried from
    the card; the kernel wrappers' refusal of inputs that require grad; one
    profiled step. The step launches no attention kernel (it computes the
    reference's _sdpa)."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import api as model_api
    from repro_torch.models import steps
    from repro_torch.train import adamw_init

    before = ops.launch_counts()
    snaps = {}

    def keep(step, model, metrics):
        if step <= 1:
            snaps[step] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    out = train_launch.run(train_launch.parse_args(TRAIN_ARGS + ["--steps", "3"]),
                           on_step=keep, log=lambda m: print(f"train: {m}", flush=True))
    hist = out["history"]
    check(all(np.isfinite(h["loss"]) for h in hist), f"train: non-finite loss {hist}")
    check(all(h["grad_norm"] > 0 for h in hist), f"train: zero grad_norm {hist}")
    unchanged = [n for n in snaps[0] if torch.equal(snaps[0][n], snaps[1][n])]
    check(not unchanged, f"train: parameters unchanged after step 1: {unchanged[:5]}")
    n_params = sum(t.numel() for t in snaps[0].values())
    print(f"train: llama3.2-1b full width ({n_params} parameters, {len(snaps[0])} tensors, "
          f"f32), batch 4 x 1024: losses {[round(h['loss'], 5) for h in hist]}, grad_norm "
          f"{[round(h['grad_norm'], 4) for h in hist]}; step ms "
          f"{[round(t * 1e3, 1) for t in out['walls']]}; {out['tokens_per_s']:.1f} tokens/s "
          f"after the first step; peak memory allocated {out['peak_gib']:.2f} GiB; every "
          f"parameter changed after step 1; remat {ARCHS['llama3.2-1b'].remat} (each layer "
          f"recomputed in the backward; PR 19 kept every layer's activations: "
          f"{PR19_TRAIN})", flush=True)
    cfg = ARCHS["llama3.2-1b"]
    model, opt = out["model"], out["opt"]
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(synthetic_lm_batches(
        vocab=cfg.vocab, seq_len=1024, batch=4, seed=1)).items()}
    step = steps.make_train_step(cfg, lr=3e-4)
    print(f"train: profile of one step: {sdpa_share(lambda: step(model, opt, batch))}",
          flush=True)
    del out, model, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    def same_start(step, model, metrics):
        if step == 0:
            diff = [n for n, p in model.named_parameters() if not torch.equal(p.cpu(), snaps[0][n])]
            check(not diff, f"train: the microbatch run starts from other weights: {diff[:3]}")
    mb = train_launch.run(train_launch.parse_args(TRAIN_ARGS + ["--steps", "1",
                                                               "--microbatch", "2"]),
                          on_step=same_start, log=lambda m: print(f"train: {m}", flush=True))
    mb_loss = abs(mb["history"][0]["loss"] - hist[0]["loss"]) / abs(hist[0]["loss"])
    mb_params = max((p.detach().cpu() - snaps[1][n]).abs().max().item()
                    for n, p in mb["model"].named_parameters())
    print(f"train: --microbatch 2 against 1 after one step from the same weights: loss rel "
          f"err {mb_loss:.3e} (tol 1e-5), params max abs err {mb_params:.3e} (tol 1e-4); "
          f"step {mb['walls'][0] * 1e3:.1f} ms, peak {mb['peak_gib']:.2f} GiB", flush=True)
    check(mb_loss < 1e-5, f"train: microbatch 2 loss off by {mb_loss}")
    check(mb_params < 1e-4, f"train: microbatch 2 params off by {mb_params}")
    del mb, snaps
    gc.collect()
    torch.cuda.empty_cache()

    # -- the card against the CPU: full width, depth cut to 2 layers for the CPU's time
    cfg2 = cfg.replace(n_layers=2)
    g_model = model_api.init_model(0, cfg2, device="cuda")
    c_model = copy.deepcopy(g_model).cpu()
    # batch 1 (2 through PR 23), to keep the script under 1100 s: S = 1024 still chunks the loss
    data = next(synthetic_lm_batches(vocab=cfg.vocab, seq_len=1024, batch=1, seed=0))
    step2 = steps.make_train_step(cfg2, lr=3e-4)
    g_model, _, gm = step2(g_model, adamw_init(g_model),
                           {k: torch.from_numpy(v).cuda() for k, v in data.items()})
    t = time.perf_counter()
    c_model, _, cm = step2(c_model, adamw_init(c_model),
                           {k: torch.from_numpy(v) for k, v in data.items()})
    cpu_s = time.perf_counter() - t
    l_err = abs(float(gm["loss"]) - float(cm["loss"])) / abs(float(cm["loss"]))
    gn_err = abs(float(gm["grad_norm"]) - float(cm["grad_norm"])) / float(cm["grad_norm"])
    p_err = max((g.detach().cpu() - c.detach()).abs().max().item() for g, c in
                zip(g_model.parameters(), c_model.parameters(), strict=True))
    print(f"train: one step card vs CPU (llama3.2-1b width, 2 layers, batch 1 x 1024, CPU "
          f"step {cpu_s:.1f} s): loss rel err {l_err:.3e} (tol 1e-5), grad_norm rel err "
          f"{gn_err:.3e} (tol 1e-4), params max abs err {p_err:.3e} (tol 1e-4)", flush=True)
    check(l_err < 1e-5, f"train: loss card vs CPU off by {l_err}")
    check(gn_err < 1e-4, f"train: grad_norm card vs CPU off by {gn_err}")
    check(p_err < 1e-4, f"train: params card vs CPU off by {p_err}")
    del g_model, c_model

    # -- each kernel wrapper refuses an input that requires grad
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.randn(1, 64, 8, 64, device="cuda", generator=gen, requires_grad=True)
    kv = torch.randn(1, 64, 2, 64, device="cuda", generator=gen)
    cases = {"flash_attention": lambda: fa.flash_attention(q, kv, kv),
             "decode_attention": lambda: da.decode_attention(
                 q[:, :1], kv, kv, torch.ones(1, 64, dtype=torch.bool, device="cuda"))}
    for kname, call in cases.items():
        try:
            call()
        except ValueError as e:
            check("no backward" in str(e), f"train: {kname} raised another error: {e}")
        else:
            fail(f"train: the {kname} wrapper took an input that requires grad")
    print("train: both kernel wrappers refuse an input that requires grad", flush=True)
    check(ops.launch_counts() == before,
          f"train: the train phase launched attention kernels {ops.launch_counts()}")
    return {"flash_attention": 0, "decode_attention": 0}


FIGURES_OUT = "chiprun_out/figures_smoke"
FIG_EPISODES = 3            # trained_opd's episodes (the launchers' quick: 12)
FIG45_HORIZON = 100         # fluctuating only (quick: the three regimes, 1200 s)
FIG45_PROACTIVE = 120       # bursty only (quick: bursty and ramp, 160 s)
FIG6_STEPS = 2              # P1-P3 (quick: P1-P4, 10 decisions)
DT_LIMIT_S = 1.0            # a tenth of the 10 s adaptation interval


@contextlib.contextmanager
def captured_serves(reports: list):
    """Append every ``Session.serve`` report made inside the block."""
    from repro_torch.api import Session
    serve = Session.serve

    def keep(self, **kw):
        rep = serve(self, **kw)
        reports.append(rep)
        return rep

    Session.serve = keep
    try:
        yield
    finally:
        Session.serve = serve


def rows_line(tag: str, rows, phase: str = "figures") -> None:
    for r in rows:
        print(f"{phase}: {tag}: " + ",".join(str(x) for x in r), flush=True)


def phase_figures() -> dict:
    """The paper's figures through the port's launchers (launch/fig*.py) on
    the card at cut sizes: bench.trained_opd (FIG_EPISODES), fig7 on its
    history, fig45 on fluctuating (FIG45_HORIZON) with the bursty proactive
    section (FIG45_PROACTIVE), fig6 on P1-P3 (FIG6_STEPS decisions), fig3 on
    one regime with one epoch per network. Gates: Random, Greedy and IPA
    equal the same episodes with device="cpu"; the card's policy and its CPU
    copy take the same greedy actions over the fig45 episode (a flip only
    at a near-tie); predict_batch card vs CPU within 1e-5; served + shed =
    offered in every runtime serve and prewarms > 0 for proactive_capacity;
    every OPD d_t below DT_LIMIT_S; no attention kernel launched."""
    import copy

    from repro_torch import api
    from repro_torch.cluster import PipelineEnv
    from repro_torch.core import OPDPolicy, policy, predictor
    from repro_torch.kernels import ops
    from repro_torch.launch import bench
    from repro_torch.launch import fig3_predictor as fig3
    from repro_torch.launch import fig6_decision_time as fig6
    from repro_torch.launch import fig7_convergence as fig7
    from repro_torch.launch import fig45_workloads as fig45

    before = ops.launch_counts()
    bench.set_results_dir(FIGURES_OUT)
    walls = {}

    def load(name):
        with open(os.path.join(FIGURES_OUT, f"{name}.json")) as f:
            return json.load(f)

    def stamp(name, t):
        walls[name] = round(time.perf_counter() - t, 1)

    try:
        t = time.perf_counter()
        params, hist = bench.trained_opd(FIG_EPISODES, force=True, device="cuda",
                                         log=lambda m: print(f"figures:{m}", flush=True))
        stamp("trained_opd", t)
        check(all(p.device.type == "cuda" for p in params.parameters()),
              "figures: the policy is not on the card")
        check(all(np.isfinite(hist[k]).all() for k in ("reward", "loss", "value_loss")),
              "figures: non-finite training history")
        t = time.perf_counter()
        rows_line("fig7", fig7.run(device="cuda", episodes=FIG_EPISODES))
        stamp("fig7", t)
        check(load("fig7_convergence")["reward"] == hist["reward"],
              "figures: fig7's history is not trained_opd's")

        reports = []
        t = time.perf_counter()
        with captured_serves(reports):
            rows_line("fig45", fig45.run(device="cuda", episodes=FIG_EPISODES,
                                         regimes=("fluctuating",), horizon=FIG45_HORIZON,
                                         proactive_regimes=("bursty",),
                                         proactive_horizon=FIG45_PROACTIVE))
        stamp("fig45", t)
        p45 = load("fig45_workloads")
        pipeline = api.get_pipeline("paper-4stage")
        by_name = {(r["experiment"]["backend"], r["experiment"]["controller"]["name"]): r
                   for r in reports}
        for name in ("random", "greedy", "ipa"):
            want = fig45._episode("fluctuating", name, None, pipeline, FIG45_HORIZON,
                                  device="cpu")
            got = by_name[("analytic", name)]
            check(all(got[k] == want[k] for k in ("cost", "qos", "rewards", "configs")),
                  f"figures: fig45 {name} on the card differs from device='cpu'")
        print("figures: fig45 random, greedy, ipa: cost, qos, rewards and configurations "
              "equal the same episodes with device='cpu'", flush=True)

        # the card's greedy policy and its CPU copy on the same states
        pipe = pipeline.build()
        scen = api.replace(api.get_scenario("fluctuating"), seed=fig45.EVAL_SEED,
                           horizon=FIG45_HORIZON)
        env = PipelineEnv(pipe, scen.eval_trace(), seed=scen.seed)
        env.reset()
        cpu_params = copy.deepcopy(params).cpu()
        on_card, on_cpu = (OPDPolicy(pipe, params, device="cuda"),
                           OPDPolicy(pipe, cpu_params, device="cpu"))
        configs, ties, done = [], [], False
        while not done:
            obs = env.observe()
            a, b = on_card.decide(obs), on_cpu.decide(obs)
            ties += [(len(configs), h, gap) for h, gap in near_tie_gaps(
                cpu_params, obs.state, policy.config_to_action(pipe, a),
                policy.config_to_action(pipe, b))]
            configs.append([list(a.z), list(a.f), list(a.b)])
            _, _, done, _ = env.step(a)
        print(f"figures: fig45 opd, card vs CPU copy on the card's {len(configs)} states: "
              f"near-tie flips {ties}", flush=True)
        check(all(gap < TIE_GAP for *_, gap in ties), f"figures: greedy actions differ at {ties}")
        check(configs == by_name[("analytic", "opd")]["configs"],
              "figures: fig45's opd episode is not the trained policy's")

        runtime = [r for r in reports if r["experiment"]["backend"] == "runtime"]
        for r in runtime:
            s = r["summary"]
            check(s["served"] + s["shed"] == s["submitted"] > 0,
                  f"figures: {r['experiment']['controller']['name']} served {s['served']} "
                  f"+ shed {s['shed']} != offered {s['submitted']}")
        pro = p45["proactive"]["bursty"]
        check(pro["proactive_capacity"]["prewarms"] > 0,
              "figures: proactive_capacity made no prewarm")
        print("figures: fig45 proactive (bursty, " + ", ".join(
            f"{arm}: p99 {v['p99']:.3f} s, cost {v['cost']:.3f}, served {v['served']}, "
            f"prewarms {v['prewarms']}" for arm, v in pro.items())
            + f"); served + shed = offered in all {len(runtime)} runtime serves", flush=True)

        ipa = by_name[("analytic", "ipa")]["decision_times"]
        print(f"figures: fig45 ipa on paper-4stage, host time a decision over {len(ipa)} "
              f"decisions: median {float(np.median(ipa)) * 1e3:.3f} ms, mean "
              f"{float(np.mean(ipa)) * 1e3:.3f} ms, max {max(ipa) * 1e3:.3f} ms", flush=True)

        episodes = []
        run_episode = fig6.run_episode

        def kept_episode(env, pol):
            episodes.append((pol, run_episode(env, pol)))
            return episodes[-1][1]

        fig6.run_episode = kept_episode
        t = time.perf_counter()
        try:
            rows_line("fig6", fig6.run(device="cuda", steps=FIG6_STEPS,
                                       pipelines=fig6.PIPELINES[:3]))
        finally:
            fig6.run_episode = run_episode
        stamp("fig6", t)
        p6 = load("fig6_decision_time")
        dts = [d for r in reports for d in r.get("decision_times", [])
               if r["experiment"]["controller"]["name"] == "opd"]
        fig6_dts = [r["decision_times"] for pol, r in episodes if isinstance(pol, OPDPolicy)]
        check([len(d) for d in fig6_dts] == [FIG6_STEPS] * 3,
              f"figures: fig6 timed {[len(d) for d in fig6_dts]} OPD decisions")
        dts += [d for ds in fig6_dts for d in ds]
        print("figures: fig6 " + ", ".join(
            f"{s.name}: IPA H {p6[s.name]['ipa_H_s']:.4f} s, OPD H {p6[s.name]['opd_H_s']:.4f} s"
            for s in fig6.PIPELINES[:3]) + f"; every OPD d_t, {len(dts)} decisions: median "
            f"{float(np.median(dts)) * 1e3:.3f} ms, max {max(dts) * 1e3:.3f} ms", flush=True)
        check(max(dts) < DT_LIMIT_S, f"figures: an OPD d_t of {max(dts)} s")

        trained = []
        train = fig3.train_predictor

        def keep(*a, **kw):
            trained.append(train(*a, **kw))
            return trained[-1]

        fig3.train_predictor = keep
        t = time.perf_counter()
        try:
            rows_line("fig3", fig3.run(device="cuda", regimes=("fluctuating",), epochs=1,
                                       forecast_epochs=1))
        finally:
            fig3.train_predictor = train
        stamp("fig3", t)
        X, _ = predictor.make_dataset([fig3.make_trace("fluctuating", seed=9)],
                                      scale=fig3.SCALE)
        with torch.no_grad():
            g = predictor.predict_batch(trained[0], torch.as_tensor(X, device="cuda"))
            c = predictor.predict_batch(copy.deepcopy(trained[0]).cpu(), torch.as_tensor(X))
        p_err = (g.cpu() - c).abs().max().item()
        print(f"figures: fig3 predict_batch of {len(X)} windows card vs CPU max abs err "
              f"{p_err:.3e} (tol 1e-5); predict latency "
              f"{load('fig3_predictor')['fluctuating']['predict_latency_ms']:.3f} ms", flush=True)
        check(bool(torch.isfinite(g).all()), "figures: non-finite predictor output")
        check(p_err < 1e-5, f"figures: predict_batch card vs CPU off by {p_err}")
    finally:
        bench.set_results_dir(None)
    print(f"figures: walls s {walls}; payloads under {FIGURES_OUT}/", flush=True)
    check(ops.launch_counts() == before,
          f"figures: the figures phase launched attention kernels {ops.launch_counts()}")
    return {"flash_attention": 0, "decode_attention": 0}


MESH_ARCH = "granite-moe-3b-a800m"
MESH_TOL = 1e-4             # sharded against one rank, f32 (tests/test_torch_distributed.py)
# the audio, hybrid, ssm and vlm families through StageExecutor(mesh=) on (1, 2), f32:
# (arch, config overrides, what was cut); all at published width
MESH_FAMILIES = [("whisper-small", {}, "published width and depth"),
                 ("zamba2-2.7b", {}, "published width and depth (54 mamba layers, 9 "
                                     "shared-block applications)"),
                 ("xlstm-125m", {}, "published width and depth"),
                 ("llava-next-mistral-7b", {"n_layers": 4},
                  "published width, depth cut to 4 of 32 layers")]
# families whose prefill is also held in float64 (parity.precision): the sharded float64
# run within MESH_TOL of the one-rank float64 run. Their f32 prefill misses MESH_TOL
# against one rank at published depth, where one rank's own f32 run lies about as far
# from float64: the miss is printed and recorded (ROADMAP.md Queue 3), and float64 holds
# the sharded program instead, as PR 20 held zamba2's bf16 miss in f32
MESH_F64 = ("zamba2-2.7b", "xlstm-125m")
LSE_CASES = [(4, 24, 8, 64, 16, "prefix"), (4, 24, 8, 64, 16, "empty_row"),
             (2, 8, 2, 64, 1024, "second_half"), (2, 8, 2, 64, 1024, "empty_row")]
# the ep2d layer at granite-moe's widths: d 1536, d_ff 512, 40 experts (48
# physical, nn.moe._phys_experts), top-8; x [B, S, d]
EP2D = dict(seed=0, d=1536, f=512, E=40, shape=(4, 8, 1536), top_k=8)


def lse_cases(timer) -> None:
    """The decode kernel's log-sum-exp output against its plain version: a
    rank's slice of granite-moe's decode cache (C = 16 of 32 slots) and a
    split cache, each with a row of no valid slot (out 0, lse -inf) and a
    row whose valid slots lie in another rank's slice; lse within 1e-5 of
    max(1, |lse|), out within 1e-5 (f32) or two bf16 ulps."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for B, H, Hkv, D, C, kind in LSE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, 1, H, D), dtype)
            k, v = (randn(gen, (B, C, Hkv, D), dtype) for _ in range(2))
            idx = torch.arange(C, device="cuda")[None, :]
            mask = (idx < C // 3 + torch.arange(B, device="cuda")[:, None]) if kind != \
                "second_half" else (idx >= C // 2).expand(B, C)
            mask = mask.contiguous()
            if kind == "empty_row":
                mask[1] = False
            out, lse = da.decode_attention(q, k, v, mask, return_lse=True)
            want, want_lse = ref.decode_attention_ref(q, k, v, mask, return_lse=True)
            torch.cuda.synchronize()
            empty = ~mask.any(1)
            fin = ~empty
            lse_err = ((lse[fin] - want_lse[fin]).abs()
                       / want_lse[fin].abs().clamp(min=1.0)).max().item()
            out_err = ((out.float() - want.float()).abs().max()
                       / want.float().abs().max().clamp(min=1.0)).item()
            tol = 1e-5 if dtype == torch.float32 else CALL_TOL[torch.bfloat16]
            ms = timer.ms(lambda q=q, k=k, v=v, m=mask: da.decode_attention(
                q, k, v, m, return_lse=True))
            print(f"mesh: lse B{B} H{H} Hkv{Hkv} D{D} C{C} {kind} {str(dtype)[6:]}: lse err "
                  f"{lse_err:.3e} (tol 1e-5), out err {out_err:.3e} (tol {tol:.3e}), "
                  f"empty rows {int(empty.sum())}, {ms:.4f} ms", flush=True)
            check(lse_err <= 1e-5 and out_err <= tol, f"mesh: lse case {kind} {dtype}")
            check(bool(torch.isneginf(lse[empty]).all()) and bool((out[empty] == 0).all()),
                  "mesh: an empty row is not out 0, lse -inf")
            check(bool(torch.isfinite(lse[fin]).all()) and not bool(out.isnan().any()),
                  "mesh: a NaN or -inf where a row has a slot")


def phase_mesh() -> dict:
    """The sharded serving program on the card: granite-moe-3b-a800m at full
    width in f32 on a (1, 2) mesh of two ranks sharing the card (gloo):
    StageExecutor(mesh=) decode steps at b = 4 (8 teacher-forced steps of
    its serving step, C = 32) and one 32-token api.forward prefill with
    shard_h, each rank's logits against the one-rank executor's within
    MESH_TOL (MoE plans replayed), every rank's flash and decode launches
    > 0, the slowest rank's step; then the same for MESH_FAMILIES (whisper's
    cross-attention cache filled from a seed, llava's 32 tokens after its
    576 patches), in one launch of the two ranks, every rank of the
    attention models launching flash and decode, decode with lse; one ep2d
    MoE layer at granite-moe's widths on (2, 2) against the one-rank layer;
    the decode kernel's lse output against its plain version (lse_cases).
    Ranks sharing one card over gloo check correctness: their times are not
    multi-card speed."""
    from repro_torch.cluster.executor import power_limit
    from repro_torch.distributed import parity
    from repro_torch.distributed.launch import backend_for, run_on_mesh

    card = f"{torch.cuda.get_device_name(0)}, {power_limit()}"
    lse_cases(Timer())
    t = time.perf_counter()
    ranks = run_on_mesh(parity.stage, (1, 2), device="cuda", args=(MESH_ARCH,), timeout=300)
    wall = time.perf_counter() - t
    errs = ranks[0]["errs"]
    for r in ranks:
        print(f"mesh: {MESH_ARCH} rank {r['rank']} of (1, 2) on {r['device']} ({card}) over "
              f"{r['backend']}: {r['weight_gib']:.3f} GiB of weights (f32), step "
              f"{r['step_ms']:.3f} ms at b4 (slowest rank, eager), launches {r['launches']} "
              f"(decode steps: {r['decode_launches']}), label {r['device_class']}, key mesh "
              f"{r['cache_key_mesh']}", flush=True)
        check(r["launches"]["flash_attention"] > 0 and r["launches"]["decode_attention"] > 0,
              f"mesh: rank {r['rank']} launched {r['launches']}")
        check(r["finite"], f"mesh: rank {r['rank']} non-finite logits")
    print(f"mesh: {MESH_ARCH} sharded vs one rank (rel to max(1, max |logits|)): {errs}; "
          f"backend {backend_for('cuda', 2)}, {len(ranks)} ranks, launch wall {wall:.1f} s",
          flush=True)
    check(max(errs.values()) <= MESH_TOL, f"mesh: sharded vs one rank {errs}")
    counts = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    check(all(r["launches"]["moe_combine"] > 0 for r in ranks),
          f"mesh: a {MESH_ARCH} rank launched no moe_combine")

    t = time.perf_counter()
    cases = [(arch, over, {}) for arch, over, _ in MESH_FAMILIES]
    fam_ranks = run_on_mesh(parity.stages, (1, 2), device="cuda", args=(cases,), timeout=600)
    wall = time.perf_counter() - t
    prec = {}
    for arch in MESH_F64:
        t = time.perf_counter()
        prec[arch] = p = run_on_mesh(parity.precision, (1, 2), device="cuda", args=(arch,),
                                     timeout=600)[0]
        print(f"mesh: {arch} prefill with shard_h, f32 rounding against float64 from the same "
              f"weights ({card}): one-rank f32 {p['one_f32_vs_f64']:.3e} (plain attention "
              f"{p['one_f32_plain_vs_f64']:.3e}; the two one-rank f32 paths apart "
              f"{p['one_f32_vs_plain']:.3e}), sharded f32 {p['sharded_f32_vs_f64']:.3e}; "
              f"sharded f64 vs one-rank f64 {p['sharded_f64_vs_one_f64']:.3e}, sharded f32 vs "
              f"one-rank f32 {p['sharded_f32_vs_one_f32']:.3e}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        check(p["sharded_f64_vs_one_f64"] <= MESH_TOL, f"mesh: {arch} sharded f64 {p}")
    for i, (arch, _, cut) in enumerate(MESH_FAMILIES):
        errs = fam_ranks[0][i]["errs"]
        attention = arch != "xlstm-125m"
        for ranks_i in fam_ranks:
            r = ranks_i[i]
            print(f"mesh: {arch} ({cut}) rank {r['rank']} of (1, 2) on {r['device']} ({card}) "
                  f"over {r['backend']}: {r['weight_gib']:.3f} GiB of weights (f32), step "
                  f"{r['step_ms']:.3f} ms at b4 (slowest rank, eager), launches "
                  f"{r['launches']} (decode steps: {r['decode_launches']}; decode with lse "
                  f"{r['lse_calls']}), cache split over {r['cache_axes']}", flush=True)
            check(r["finite"], f"mesh: {arch} rank {r['rank']} non-finite logits")
            if attention:
                check(r["launches"]["flash_attention"] > 0
                      and r["launches"]["decode_attention"] > 0 and r["lse_calls"] > 0,
                      f"mesh: {arch} rank {r['rank']} launched {r['launches']}, "
                      f"lse {r['lse_calls']}")
            for k in counts:
                counts[k] += r["launches"][k]
        print(f"mesh: {arch} sharded vs one rank (rel to max(1, max |logits|)): {errs}",
              flush=True)
        check(errs["decode"] <= MESH_TOL, f"mesh: {arch} sharded decode vs one rank {errs}")
        fwd = errs["forward_shard_h"]
        if fwd > MESH_TOL and arch in prec:
            p = prec[arch]
            print(f"mesh: MISS {arch} f32 prefill {fwd:.3e} > {MESH_TOL} from one rank "
                  f"(recorded, ROADMAP.md Queue 3): from float64 one-rank f32 lies "
                  f"{p['one_f32_vs_f64']:.3e}, sharded f32 {p['sharded_f32_vs_f64']:.3e}; "
                  f"held in float64 instead, sharded {p['sharded_f64_vs_one_f64']:.3e} from "
                  f"one rank", flush=True)
        else:
            check(fwd <= MESH_TOL, f"mesh: {arch} sharded prefill vs one rank {errs}")
    print(f"mesh: {len(MESH_FAMILIES)} families on (1, 2): launch wall {wall:.1f} s", flush=True)

    spec = dict(EP2D)
    top_k = spec.pop("top_k")
    t = time.perf_counter()
    got = run_on_mesh(parity.moe_layer, (2, 2), device="cuda", args=(spec, top_k, True),
                      timeout=300)[0]
    y_err = parity.rel_err(torch.from_numpy(got["y"]), torch.from_numpy(got["y_one"]))
    lb_err = abs(got["lb_loss"] - got["lb_loss_one"])
    print(f"mesh: ep2d MoE layer {EP2D} on (2, 2), 4 ranks ({card}): y err {y_err:.3e}, lb_loss "
          f"{got['lb_loss']:.6f} vs {got['lb_loss_one']:.6f}, dropped "
          f"{got['dropped_frac']:.4f}; {time.perf_counter() - t:.1f} s", flush=True)
    check(y_err <= MESH_TOL and lb_err <= MESH_TOL, "mesh: ep2d vs one rank")
    return counts


MESH_TRAIN_OUT = "build/mesh_train"      # ignored by git; emptied after the phase
MESH_TRAIN_SHAPE = (2, 2)
# (arch, config overrides, batch, seq, steps, note, one-rank step in the ranks):
# llama3.2-1b at published width and depth; granite-moe at published width,
# depth cut to 4; their one-rank states are written under MESH_TRAIN_OUT
# (one_rank_reference). The audio, ssm, hybrid and vlm families at published
# width, their inputs besides the tokens drawn by parity.numpy_lm_batch (seq
# counts text tokens: llava's sequence is its 576 patches and its text, its
# labels -100 on the patches); each rank runs their one-rank step itself, one
# rank at a time (parity.train), since writing every model's state would pass
# what the card machine's disk takes
MESH_TRAIN = [("llama3.2-1b", {}, 4, 512, 2, "published width and depth", False),
              ("granite-moe-3b-a800m", {"n_layers": 4}, 4, 512, 1,
               "published width, depth cut to 4 of 32 layers, MoE plans replayed", False),
              ("whisper-small", {}, 2, 64, 1,
               "published width and depth, 1500 encoder frames", True),
              ("xlstm-125m", {}, 2, 64, 1,
               "published width and depth, 3 sLSTM layers of 12", True),
              ("zamba2-2.7b", {"n_layers": 6}, 2, 64, 1,
               "published width, depth cut to 1 group of 6 mamba layers of 9 (6 of 54 "
               "layers) under the shared block", True),
              ("llava-next-mistral-7b", {"n_layers": 2}, 2, 64, 1,
               "published width, depth cut to 2 of 32 layers, 576 patches + 64 text "
               "tokens", True)]
# rel to max(1, max-abs); "near": elements where the one-rank step took a clipped
# gradient within 100 eps of 0, held within 2 lr a step (AdamW's g / (|g| + eps)
# maps the gradient's last bits there to a move of up to lr; tests/test_torch_train.py)
TRAIN_TOLS = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4, "m": 1e-4, "v": 1e-4,
              "near": 2 * 3e-4}


def one_rank_reference(arch, overrides, batch, seq, n_steps) -> tuple[str, dict]:
    """The one-rank train step on the card from seed 0 (parity.train_reference):
    the last step's parameters and moments, and every step's loss and
    grad_norm, written under MESH_TRAIN_OUT for the ranks to read their
    blocks of; the card freed after. -> (the file, what to print)."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import parity
    from repro_torch.models import api

    cfg = ARCHS[arch].replace(**overrides)
    data = {k: torch.from_numpy(v).cuda()
            for k, v in parity.numpy_lm_batch(1, cfg, batch, seq).items()}
    model = api.init_model(0, cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = parity.train_reference(cfg, model, data, steps=n_steps, grads=False,
                                 keep=(n_steps - 1,))
    info = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "step_ms": [round(x * 1e3, 1) for x in ref["step_s"]]}
    del model, data
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(MESH_TRAIN_OUT, exist_ok=True)
    path = os.path.join(MESH_TRAIN_OUT, f"{arch}_one_rank.pt")
    t = time.perf_counter()
    torch.save(ref, path)
    info["save_s"] = time.perf_counter() - t
    return path, info


def phase_mesh_train() -> dict:
    """The sharded train step on the card: each MESH_TRAIN model on a
    (2, 2) mesh of four ranks sharing the card over gloo, with shard_h,
    ZeRO-1 moments and the batch rows over "data", held against the
    one-rank step on the card from the same seed: the one-rank runs of the
    models whose ranks do not run it go first (one_rank_reference), then
    one launch of ranks runs every case (parity.trains), each rank reading
    its blocks of the one-rank state (mmap) or running the one-rank step
    itself, within TRAIN_TOLS. Per rank: GiB of parameters, grads and
    moments beside the rules' bytes, the peak, the step ms. Ranks sharing
    one card over gloo check correctness: their times are not multi-card
    speed (in a whole run the dry run's host count runs beside this
    phase and the three before it). The step computes the reference's _sdpa
    and launches no attention kernel."""
    from repro_torch.cluster.executor import power_limit
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import parity
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.launch import run_on_mesh
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    card = f"{torch.cuda.get_device_name(0)}, {power_limit()}"
    shape = MESH_TRAIN_SHAPE
    paths, infos = [], []
    for arch, over, batch, seq, n_steps, _, in_rank in MESH_TRAIN:
        path, info = (None, {}) if in_rank else one_rank_reference(arch, over, batch, seq,
                                                                   n_steps)
        paths.append(path)
        infos.append(info)
    cases = [(arch, over, dict(smoke=False, batch=batch, seq=seq, gather_moments=False,
                                **({"want": path} if path else
                                   {"steps": n_steps, "check_grads": False})))
             for (arch, over, batch, seq, n_steps, _, _), path in zip(MESH_TRAIN, paths,
                                                                       strict=True)]
    t = time.perf_counter()
    try:
        ranks = run_on_mesh(parity.trains, shape, device="cuda", args=(cases,), timeout=900)
    finally:
        for path in paths:
            if path:
                os.remove(path)
    wall = time.perf_counter() - t
    gib = 2 ** 30
    for i, (arch, over, batch, seq, n_steps, note, _) in enumerate(MESH_TRAIN):
        for rank in ranks:
            r = rank[i]
            print(f"mesh_train: {arch} rank {r['rank']} of {shape} on {r['device']} ({card}) "
                  f"over {r['backend']}: params {r['held']['params'] / gib:.3f} GiB (rules "
                  f"{r['rule']['params'] / gib:.3f}), grads {r['held']['params'] / gib:.3f} GiB "
                  f"(f32, a parameter block each), moments {r['held']['opt'] / gib:.3f} GiB "
                  f"(rules {r['rule']['opt'] / gib:.3f}, ZeRO-1); peak allocated "
                  f"{r['peak_bytes'] / gib:.2f} GiB; steps ms "
                  f"{[round(x * 1e3, 1) for x in r['step_s']]}; errs "
                  + ", ".join(f"{k} {v:.3e}" for k, v in r["errs"].items())
                  + f"; worst at {r['where']}; elements near a zero gradient "
                  f"{r['near_counts']}", flush=True)
            check(r["held"]["params"] == r["rule"]["params"] and
                  r["held"]["opt"] == r["rule"]["opt"],
                  f"mesh_train: rank {r['rank']} holds other bytes than the rules'")
            check(r["finite"], f"mesh_train: rank {r['rank']} non-finite loss or grad_norm")
            for k, v in r["errs"].items():
                kind, step = k.rsplit("_", 1)
                check(v <= TRAIN_TOLS[kind] * (int(step) if kind == "near" else 1),
                      f"mesh_train: {arch} rank {r['rank']} {k} off by {v:.3e}")
        info, r0 = infos[i], ranks[0][i]
        slow = max(max(rank[i]["step_s"]) for rank in ranks) * 1e3
        cfg = ARCHS[arch].replace(**over)
        one = (f"one rank on the card: steps {info['step_ms']} ms, peak "
               f"{info['peak_gib']:.2f} GiB; one-rank state written in {info['save_s']:.1f} s"
               if info else "one rank on the card, run by each rank in turn: steps "
               + str([round(x * 1e3, 1) for x in r0["ref_step_s"]]) + " ms (rank 0)")
        print(f"mesh_train: {arch} ({note}; "
              f"{sum(p.numel() for p in shd.abstract_params(cfg).values())} parameters, f32, "
              f"remat {cfg.remat}), batch {batch} x {seq}, {n_steps} step(s) on {shape} with "
              f"shard_h and ZeRO-1: losses {[round(m['loss'], 6) for m in r0['metrics']]} vs "
              f"one rank {[round(m['loss'], 6) for m in r0['want_metrics']]}, grad_norm "
              f"{[round(m['grad_norm'], 5) for m in r0['metrics']]}; slowest rank's step "
              f"{slow:.1f} ms; {one}", flush=True)
    print(f"mesh_train: one launch of {len(ranks)} ranks for {len(MESH_TRAIN)} models: "
          f"{wall:.1f} s", flush=True)
    after = ops.launch_counts()
    check(all(after[k] == before[k] for k in ("flash_attention", "decode_attention")),
          f"mesh_train: the phase launched attention kernels {after}")
    # granite-moe's one-rank reference trains on the card in this process
    return {k: after[k] - before[k] for k in after}


BENCH_OUT = "chiprun_out/bench_smoke"
BENCH_ENVS = (1, 32)        # train_throughput's num_envs points (full: 1, 8, 32)
BENCH_SECONDS = 300         # train_throughput's episode: 30 decisions (full: 1200 s)


def phase_bench() -> dict:
    """The throughput launchers on the card at cut sizes, after the dryrun
    phase: launch/train_throughput.py (one BENCH_SECONDS episode on the
    legacy loop, vec_rollout at BENCH_ENVS, two timed passes each),
    launch/runtime_throughput.py --quick (serve3 x every scenario, greedy,
    60 s of virtual time: served == submitted), launch/roofline.py over the
    dryrun phase's records in DRYRUN_OUT (one row per OK record, the measured
    ones with their ms and share of the bound). Gates: finite positive
    rates, every request served, the roofline's rows match the records, no
    attention kernel launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import bench, roofline, runtime_throughput, train_throughput

    before = ops.launch_counts()
    bench.set_results_dir(BENCH_OUT)

    def load(name):
        with open(os.path.join(BENCH_OUT, f"{name}.json")) as f:
            return json.load(f)

    try:
        t = time.perf_counter()
        rows_line("train_throughput", train_throughput.run(
            device="cuda", env_counts=BENCH_ENVS, seconds=BENCH_SECONDS, legacy_eps=1,
            reps=2), phase="bench")
        tp = load("train_throughput")
        rates = [tp["legacy"]["episodes_per_s"]] + [
            v["episodes_per_s"] for v in tp["vectorized"].values()]
        print(f"bench: train_throughput in {time.perf_counter() - t:.1f} s on "
              f"{tp['device']['name']} ({tp['device']['power_limit']}): episodes/s legacy "
              f"{rates[0]:.3f}, " + ", ".join(
                  f"{n} envs {v['episodes_per_s']:.3f} (first pass {v['first_pass_s']:.3f} s)"
                  for n, v in tp["vectorized"].items()), flush=True)
        check(all(np.isfinite(r) and r > 0 for r in rates),
              f"bench: train_throughput rates {rates}")

        t = time.perf_counter()
        rows_line("runtime_throughput", runtime_throughput.run(quick=True, device="cuda"),
                  phase="bench")
        rt = {k: v for k, v in load("runtime_throughput").items() if k != "device"}
        print(f"bench: runtime_throughput --quick in {time.perf_counter() - t:.1f} s: "
              + ", ".join(f"{k} {v['served']}/{v['submitted']}" for k, v in rt.items()),
              flush=True)
        check(all(v["served"] == v["submitted"] > 0 for v in rt.values()),
              "bench: runtime_throughput dropped requests")

        rows_line("roofline", roofline.run(device="cuda", dryrun_dir=DRYRUN_OUT),
                  phase="bench")
        records = roofline.load_records(DRYRUN_OUT)
        tab = roofline.table(dryrun_dir=DRYRUN_OUT)
        oks = [x for x in tab if x["status"] == "OK"]
        measured = [x for x in oks if x["measured_ms"] is not None]
        print(f"bench: roofline over {len(records)} records: {len(oks)} OK rows, "
              f"{len(measured)} measured", flush=True)
        for line in roofline.markdown(dryrun_dir=DRYRUN_OUT).splitlines():
            print(f"bench: {line}", flush=True)
        check(len(oks) == sum(r["status"] == "OK" for r in records) > 0,
              f"bench: roofline rows {len(oks)} for the OK records")
        check(all(x["collective_s"] is None for x in oks), "bench: a collective term")
    finally:
        bench.set_results_dir(None)
    print(f"bench: payloads under {BENCH_OUT}/", flush=True)
    check(ops.launch_counts() == before,
          f"bench: the bench phase launched attention kernels {ops.launch_counts()}")
    return {"flash_attention": 0, "decode_attention": 0}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="GPU smoke test of the PyTorch/CUDA port")
    ap.add_argument("--phases", nargs="+", choices=sorted(PHASES),
                    help="run only these phases after the build (no kernel summary and "
                         "no device line); the default runs every phase")
    only = ap.parse_args(argv).phases
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

    if only:
        for name in only:
            timed(name, PHASES[name])
        print(f"phases {only} passed", flush=True)
        return
    run_all(smi)


def timed(name, fn, *args):
    gc.collect()
    torch.cuda.empty_cache()        # free the earlier phase's models first
    t = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    return out


def run_all(smi: str):
    """Every phase in order, then the kernel summary and the device line."""
    from repro_torch.kernels import build
    summary = timed("kernels", phase_kernels, Timer())
    serve_counts, stage = timed("serve", phase_serve)
    decode_counts = timed("decode", phase_decode, stage.params[0])
    del stage                       # the runtime phase builds its own models
    runtime_counts = timed("runtime", phase_runtime)
    opd_counts = timed("opd", phase_opd)
    forecast_counts = timed("forecast", phase_forecast)
    calibrate_counts = timed("calibrate", phase_calibrate)
    families_counts = timed("families", phase_families)
    paper4_counts = timed("paper4", phase_paper4)
    # the dry run's host count (minutes of worker time) runs beside the next five
    # phases: their gates read no clock but the figures' d_t (< 1 s, it takes ms)
    count = start_dryrun_count()
    try:
        twin_counts = timed("twin", phase_twin)
        train_counts = timed("train", phase_train)
        figures_counts = timed("figures", phase_figures)
        mesh_counts = timed("mesh", phase_mesh)
        mesh_train_counts = timed("mesh_train", phase_mesh_train)
        dryrun_counts = timed("dryrun", phase_dryrun, count)
    finally:
        stop(count[0])
    bench_counts = timed("bench", phase_bench)

    phases = {"serve": serve_counts, "decode": decode_counts, "runtime": runtime_counts,
              "opd": opd_counts, "forecast": forecast_counts, "calibrate": calibrate_counts,
              "families": families_counts, "paper4": paper4_counts, "twin": twin_counts,
              "train": train_counts, "figures": figures_counts, "mesh": mesh_counts,
              "mesh_train": mesh_train_counts, "dryrun": dryrun_counts, "bench": bench_counts}
    kernels = []
    for name in build.KERNELS:
        each = {ph: c.get(name, 0) for ph, c in phases.items()}
        launches = sum(each.values())
        print(f"launches {name}: " + ", ".join(f"{ph} {n}" for ph, n in each.items()),
              flush=True)
        check(launches > 0, f"{name} never launched on the main path")
        row = summary[name]
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": row["max_abs_err"],
                        "max_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "replaced_ms": row.get("replaced_ms"),
                        "shape": row["shape"], "dtype": row["dtype"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


# the phases that take no argument, by name (--phases)
PHASES = {"runtime": phase_runtime, "opd": phase_opd, "forecast": phase_forecast,
          "calibrate": phase_calibrate, "families": phase_families, "paper4": phase_paper4,
          "twin": phase_twin, "train": phase_train, "figures": phase_figures,
          "mesh": phase_mesh, "mesh_train": phase_mesh_train, "dryrun": phase_dryrun,
          "bench": phase_bench}


if __name__ == "__main__":
    main()
