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
The last two lines are the kernel summary and the device line, as JSON.
Imports only torch, numpy and the port (never jax or the JAX package).
"""
from __future__ import annotations

import contextlib
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
        for shape in SLICE_FA + PREFILL_FA:
            rows.append(flash_case(timer, gen, shape, dtype, timed=True))
        for shape in RAGGED_FA:
            rows.append(flash_case(timer, gen, shape, dtype))
        for window in (32, 64, 128):
            rows.append(flash_case(timer, gen, (1, 256, 4, 2, 64), dtype, window,
                                   timed=dtype == torch.float32))
        rows.append(flash_case(timer, gen, (1, 128, 4, 2, 64), dtype, causal=False))
        rows.append(decode_case(timer, gen, *SLICE_DEC, dtype, timed=True))
        for shape in TIMED_DEC:
            rows.append(decode_case(timer, gen, *shape, dtype, timed=True))
        for name in DEC_MASKS:
            rows.append(decode_case(timer, gen, *DEC_MASK_SHAPE, None, dtype, mask=name))
        for name in ("holes", "single_slot"):
            rows.append(decode_case(timer, gen, *DEC_RAGGED_SHAPE, None, dtype, mask=name))
        rows.append(decode_case(timer, gen, *DEC_RAGGED_SHAPE, 999, dtype))
    rows.append(decode_case(timer, gen, 3, 8, 4, 64, 512, [37, 512, 256], torch.float32))
    rows.append(decode_case(timer, gen, 2, 8, 2, 64, 256, [0, 100], torch.float32))
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

    kernels = []
    for name in build.KERNELS:
        launches = serve_counts[name] + decode_counts[name]
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
