"""End-to-end LM training on the PyTorch port (the twin of
``examples/train_lm.py``: the same flags and printed lines, plus
``--device``): train a ~100M-parameter model for a few hundred steps on the
synthetic Markov-automaton corpus and watch the loss fall well below log(V).

    PYTHONPATH=src python examples/train_lm_torch.py [--arch xlstm-125m] [--steps 300] \
        [--device cpu]

Uses the same ``models.steps.make_train_step`` as
``repro_torch.launch.train`` (AdamW from ``train.adamw_init``, batches from
``data.tokens.synthetic_lm_batches``), on ``--device`` (default cuda).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import api, steps
from repro_torch.train import adamw_init

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="xlstm-125m", choices=sorted(ARCHS))
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--seq-len", type=int, default=256)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--d-model", type=int, default=None,
                help="override width (default: ~100M-param reduction)")
ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
args = ap.parse_args()
dev = resolve_device(args.device)

base = ARCHS[args.arch]
# reduce to ~100M params for a quickly trainable run, keep the family intact
cfg = base.replace(n_layers=min(base.n_layers, 8),
                   d_model=args.d_model or min(base.d_model, 512),
                   n_heads=min(base.n_heads, 8),
                   n_kv=min(base.n_kv, 8),
                   d_ff=min(base.d_ff, 2048) if base.d_ff else 0,
                   n_experts=min(base.n_experts, 4) if base.n_experts else 0,
                   vocab=min(base.vocab, 32768))
print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params "
      f"({cfg.active_param_count() / 1e6:.1f}M active), vocab={cfg.vocab}")

model = api.init_model(0, cfg, device=dev)
opt = adamw_init(model)
train = steps.make_train_step(cfg, lr=1e-3)
data = synthetic_lm_batches(vocab=cfg.vocab, seq_len=args.seq_len,
                            batch=args.batch, seed=0)

log_v = float(np.log(cfg.vocab))
print(f"uniform-token floor: log(V) = {log_v:.3f}")
t0 = time.time()
first = None
for step in range(1, args.steps + 1):
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    model, opt, metrics = train(model, opt, batch)
    if step == 1:
        first = float(metrics["loss"])
    if step % 20 == 0 or step == 1:
        print(f"step {step:4d}  loss={float(metrics['loss']):7.4f}  "
              f"grad_norm={float(metrics['grad_norm']):8.3f}  "
              f"{(time.time() - t0) / step:5.2f}s/step")

final = float(metrics["loss"])
print(f"\nloss {first:.3f} -> {final:.3f} "
      f"({'below' if final < log_v else 'NOT below'} log V = {log_v:.3f})")
if not final < first:
    raise SystemExit("loss must decrease")
