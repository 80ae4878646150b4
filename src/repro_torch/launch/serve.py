"""Serving launcher: batched single-token decode against a KV cache — the
data plane the OPD controller manages — plus the event-driven pipeline mode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        [--full] [--batch 4] [--context 128] [--tokens 32] [--device cuda]

    PYTHONPATH=src python -m repro_torch.launch.serve --pipeline \
        [--scenario bursty] [--horizon 120] [--policy greedy] [--seed 3] \
        [--cluster edge-hetero-3]

Single-arch mode builds the model from a seed with random weights (the
``--smoke`` reduced variant unless ``--full``), starts from an empty cache
and feeds back the argmax token each step. On a CUDA device every layer's
attention is the decode_attention Hopper kernel. ``--pipeline`` serves an
arrival scenario through the event-driven runtime with a registered
controller in the loop and prints per-interval telemetry, line for line as
the reference launcher does; it runs the virtual-time loop alone and does
not touch the card. ``--fleet`` raises until the fleet is ported (ROADMAP
Queue 1 item 10).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ArchConfig


@dataclass
class DecodeRun:
    prompt: np.ndarray            # [B, 1] the first token fed
    tokens: np.ndarray            # [B, T] tokens produced, step by step
    logits: torch.Tensor | None   # [B, T, V] per-step logits when kept
    seconds: float                # wall time of the whole loop
    first_seconds: float          # wall time of the first step (kernel build included)


def decode_loop(model, cfg: ArchConfig, *, batch: int, context: int, tokens: int,
                keep_logits: bool = False) -> DecodeRun:
    """Decode ``tokens`` steps from an empty cache of ``context`` slots on
    the model's device, feeding back the argmax token each step."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab, (batch, 1))
    cache = api.init_cache(cfg, batch, context, device=device)
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    out_tokens, kept = [], []
    t0 = time.perf_counter()
    first = 0.0
    with torch.inference_mode():
        for i in range(tokens):
            logits, cache = api.decode_step(model, {"tokens": tok}, cache, cfg)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out_tokens.append(tok[:, 0].cpu().numpy())
            if keep_logits:
                kept.append(logits[:, -1])
            if i == 0:
                first = time.perf_counter() - t0
    seconds = time.perf_counter() - t0
    return DecodeRun(prompt=prompt.astype(np.int32), tokens=np.stack(out_tokens, 1),
                     logits=torch.stack(kept, 1) if keep_logits else None,
                     seconds=seconds, first_seconds=first)


def _ms(v) -> str:
    """Milliseconds formatter, null-safe (summary emits None when nothing
    completed)."""
    return "n/a" if v is None else f"{v * 1e3:.0f}ms"


def run_pipeline(args) -> dict:
    from repro_torch import api

    pipeline = api.get_pipeline("serve2")
    if args.cluster:
        # place the pipeline on a registered (possibly heterogeneous)
        # cluster topology instead of the homogeneous scalar pool
        pipeline = api.replace(pipeline, cluster=api.get_cluster(args.cluster))
    exp = api.ExperimentSpec(
        pipeline=pipeline,
        scenario=api.replace(api.get_scenario(args.scenario), rate=args.rate,
                             seed=args.seed, horizon=args.horizon),
        controller=api.replace(api.get_controller(args.policy),
                               seed=args.seed))
    sess = api.Session.from_spec(exp)
    sess.train(log=print)

    def show(env, cfg, info):
        line = (f"t={env.runtime.now:5.0f}s z={cfg.z} f={cfg.f} b={cfg.b} "
                f"demand={info['demand']:5.1f}/s served={info['processed']:4d} "
                f"p95={info['p95'] * 1e3:7.1f}ms backlog={info['backlog']}")
        if args.cluster:
            line += (" nodes=" + "/".join(f"{u:.2f}"
                                          for u in info["node_utilization"])
                     + f" migrations={info['migrations']}")
        print(line)

    rep = sess.serve(on_step=show)
    s = rep["summary"]
    print(f"served {s['served']} requests ({s['throughput_rps']:.1f} req/s) "
          f"p50={_ms(s['p50'])} p95={_ms(s['p95'])} p99={_ms(s['p99'])}")
    if args.cluster:
        print(f"cluster {args.cluster}: "
              f"{s['migrations']} replica migrations, node utilization "
              + " ".join(f"{u:.2f}" for u in s.get("node_utilization", [])))
    return rep


def main(argv=None):
    from repro_torch.api import list_clusters, list_controllers, list_scenarios

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pipeline", action="store_true",
                    help="serve an arrival scenario through the event-driven "
                         "pipeline runtime instead of single-arch decode")
    ap.add_argument("--scenario", default="bursty", choices=list_scenarios())
    ap.add_argument("--policy", default="greedy", choices=list_controllers())
    ap.add_argument("--cluster", default=None, choices=list_clusters(),
                    help="place the pipeline on a registered cluster "
                         "topology (default: homogeneous scalar pool)")
    ap.add_argument("--fleet", default=None,
                    help="serve a registered multi-tenant fleet (not ported "
                         "yet: ROADMAP Queue 1 item 10)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--rate", type=float, default=25.0)
    args = ap.parse_args(argv)

    if args.fleet:
        raise NotImplementedError(
            f"--fleet {args.fleet}: the multi-tenant fleet is not ported yet "
            "(ROADMAP Queue 1 item 10)")
    if args.pipeline:
        return run_pipeline(args)

    cfg = ARCHS[args.arch].smoke() if args.smoke else ARCHS[args.arch]
    device = resolve_device(args.device)
    model = api.init_model(0, cfg, device=device)
    run = decode_loop(model, cfg, batch=args.batch, context=args.context,
                      tokens=args.tokens)
    toks = args.batch * args.tokens
    print(f"first token (incl. kernel build): {run.first_seconds:.2f}s")
    print(f"decoded {toks} tokens in {run.seconds:.2f}s "
          f"({toks / run.seconds:.1f} tok/s, batch {args.batch}, {device})")
    print("sample:", run.tokens[0][:16])
    return run


if __name__ == "__main__":
    main()
