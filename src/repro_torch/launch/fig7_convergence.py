"""Fig. 7 — OPD training convergence on the card: training loss, value loss
and mean episode reward should all stabilise; reward should converge to a
higher value than where it started (the counterpart of the reference's
``benchmarks/fig7_convergence.py``, same rows and payload keys).

    PYTHONPATH=src python -m repro_torch.launch.fig7_convergence [--quick] [--device cpu]

The history is ``bench.trained_opd``'s, trained on ``device`` (or read from
its cache under the out dir).
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results, trained_opd


def run(quick: bool = False, *, device="cuda", episodes: int | None = None):
    resolve_device(device)
    _, hist = trained_opd(episodes=episodes or (12 if quick else 36), device=device)
    rewards = np.asarray(hist["reward"], dtype=np.float64)
    losses = np.asarray(hist["loss"], dtype=np.float64)
    vlosses = np.asarray(hist["value_loss"], dtype=np.float64)
    k = max(3, len(rewards) // 4)
    payload = {
        "episodes": len(rewards),
        "reward": rewards.tolist(),
        "loss": losses.tolist(),
        "value_loss": vlosses.tolist(),
        "reward_first_k": float(rewards[:k].mean()),
        "reward_last_k": float(rewards[-k:].mean()),
        "value_loss_first_k": float(vlosses[:k].mean()),
        "value_loss_last_k": float(vlosses[-k:].mean()),
    }
    save_results("fig7_convergence", payload, device=device)
    return [
        ("fig7", "episodes", len(rewards), ""),
        ("fig7", "reward_first_quarter", round(payload["reward_first_k"], 2),
         "reward converges to a higher value"),
        ("fig7", "reward_last_quarter", round(payload["reward_last_k"], 2),
         "should exceed first quarter"),
        ("fig7", "value_loss_first_quarter", round(payload["value_loss_first_k"], 4),
         "value loss decreases"),
        ("fig7", "value_loss_last_quarter", round(payload["value_loss_last_k"], 4),
         "should be below first"),
    ]


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
