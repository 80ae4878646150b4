"""Analytic TPU-v5e performance model for the assigned architectures.

Replaces the paper's offline profiling of TensorRT/ONNX variants on GPUs:
each ModelVariant's (alpha, beta) latency curve, chip cost and accuracy proxy
are derived from the architecture's arithmetic (active params, FLOPs/token,
KV bytes/token) against v5e constants. The same constants feed the §Roofline
analysis, so the RL environment's physics and the dry-run cost model agree.

The port keeps the reference's v5e constants unchanged, so that every
``ModelVariant`` equals the reference's bit for bit: the serving runtime's
virtual time models a TPU v5e, not the H100 that runs the live executors.
The H100's own ``(alpha, beta)`` come from measured calibration
(``cluster/calibration.py``, ``PipelineSpec(perf_source="calibrated")``),
not from data-sheet constants.
"""
from __future__ import annotations

import math

from repro_torch.core.mdp import ModelVariant, Pipeline, Task
from repro_torch.models.config import ArchConfig

PEAK_FLOPS = 197e12       # bf16 / chip
HBM_BW = 819e9            # bytes/s / chip
HBM_CAP = 16e9            # bytes / chip
EFFICIENCY = 0.55         # sustained fraction of peak (MFU-style derate)
DISPATCH_OVERHEAD = 4e-3  # s, per-batch fixed serving overhead (queue+launch)
TOKENS_PER_REQ = 64       # decode tokens per served request (pipeline hop)


def flops_per_token(cfg: ArchConfig) -> float:
    """Forward FLOPs per generated/processed token ~= 2 * active params."""
    return 2.0 * cfg.active_param_count()


def weight_bytes(cfg: ArchConfig, bytes_per_param: float = 2.0) -> float:
    return cfg.param_count() * bytes_per_param


def chips_for(cfg: ArchConfig, *, bytes_per_param: float = 2.0) -> int:
    """Replica footprint: weights (+ Adam-free serving) must fit HBM with
    ~30% headroom for KV cache and activations."""
    need = weight_bytes(cfg, bytes_per_param) / (HBM_CAP * 0.7)
    return max(1, math.ceil(need))


def variant_from_arch(cfg: ArchConfig, *, quant: str = "bf16",
                      accuracy: float | None = None) -> ModelVariant:
    """Build a serving ModelVariant from an architecture config.

    quant in {bf16, int8, int4} scales bytes (and degrades the accuracy
    proxy) — this mirrors the paper's TensorRT/quantisation variants.
    """
    bpp = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}[quant]
    acc_drop = {"bf16": 0.0, "int8": 0.025, "int4": 0.07}[quant]
    chips = chips_for(cfg, bytes_per_param=bpp)
    fpt = flops_per_token(cfg)
    # A request = TOKENS_PER_REQ decode steps. Each step reads the weights
    # once for the WHOLE batch (memory-bound decode, amortised across b) and
    # pays per-item compute: latency(b) = alpha + beta*b with
    #   alpha = dispatch + K * weight-read time   (per batch)
    #   beta  = K * compute time per token        (per item)
    # -> batching amortises the weight stream, the paper's b knob is a real
    #    throughput/latency trade-off.
    t_mem = weight_bytes(cfg, bpp) / (chips * HBM_BW)
    t_flop = fpt / (chips * PEAK_FLOPS * EFFICIENCY)
    alpha = DISPATCH_OVERHEAD + TOKENS_PER_REQ * t_mem
    beta = TOKENS_PER_REQ * t_flop
    if accuracy is None:
        # monotone-in-active-params proxy, calibrated to ~[0.60, 0.96]
        ap = cfg.active_param_count()
        accuracy = min(0.96, 0.50 + 0.095 * math.log10(max(ap, 1e6) / 1e6))
    accuracy = max(0.3, accuracy - acc_drop)
    return ModelVariant(
        name=f"{cfg.name}:{quant}",
        accuracy=round(accuracy, 4),
        cost=float(chips),
        resource=float(chips),
        alpha=alpha,
        beta=beta,
    )


def make_pipeline(arch_cfgs: list[list[ArchConfig]], *, name: str = "pipeline",
                  f_max: int = 8, b_max: int = 32, w_max: float = 64.0,
                  quants: tuple[str, ...] = ("bf16", "int8", "int4"),
                  topology=None) -> Pipeline:
    """One Task per stage; variants = archs × quantisation levels.
    ``topology`` (a ``cluster.topology.ClusterTopology``; None = homogeneous
    scalar pool of capacity ``w_max``) places stage replicas on nodes."""
    tasks = []
    for i, cfgs in enumerate(arch_cfgs):
        variants = tuple(variant_from_arch(c, quant=q)
                         for c in cfgs for q in quants)
        tasks.append(Task(name=f"stage{i}", variants=variants))
    return Pipeline(name=name, tasks=tuple(tasks), f_max=f_max, b_max=b_max,
                    w_max=w_max, topology=topology)


def default_pipeline() -> Pipeline:
    """The paper-style 4-stage pipeline (e.g. detect -> classify -> caption ->
    summarise), stages backed by assigned archs of increasing size."""
    from repro_torch.configs import ARCHS
    stages = [
        [ARCHS["whisper-small"], ARCHS["xlstm-125m"]],
        [ARCHS["llama3.2-1b"], ARCHS["starcoder2-3b"]],
        [ARCHS["granite-moe-3b-a800m"], ARCHS["zamba2-2.7b"]],
        [ARCHS["granite-3-8b"], ARCHS["llava-next-mistral-7b"]],
    ]
    return make_pipeline(stages, name="edge-4stage", w_max=64.0)
