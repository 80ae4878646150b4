"""Serving launcher: batched single-token decode against a KV cache — the
data plane the OPD controller manages.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        [--full] [--batch 4] [--context 128] [--tokens 32] [--device cuda]

The model is built from a seed with random weights (the ``--smoke`` reduced
variant unless ``--full``), the cache starts empty and each step feeds back
the argmax token. On a CUDA device every layer's attention is the
decode_attention Hopper kernel. The reference's ``--pipeline`` and
``--fleet`` modes come with the runtime and fleet slices.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

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
