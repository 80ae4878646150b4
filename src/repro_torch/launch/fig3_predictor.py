"""Fig. 3 — learned load prediction accuracy on the card (paper: SMAPE ~6%;
the counterpart of the reference's ``benchmarks/fig3_predictor.py``: same
epochs, learning rates, scale, rows and payload keys).

    PYTHONPATH=src python -m repro_torch.launch.fig3_predictor [--quick] [--device cpu]

Two sections:

1. The paper-faithful §IV-A predictor: per workload regime, train the
   25-unit LSTM + dense(1) on held-out seeds on ``device``, report SMAPE on
   an unseen seed and the per-regime single-prediction latency (paper:
   "trained to predict workloads in under 50 milliseconds"), each regime's
   *own* params, timed with the shared min-of-k harness (``timing``, the
   device synchronised inside the clock).
2. The multi-horizon forecaster (``core/forecast.py``): both backbones
   (lstm / mlstm) trained on the fluctuating regime, SMAPE and q90 pinball
   loss per horizon {5, 10, 20, 60} s on an unseen seed, plus single-window
   latency and batch predictions/s.

``run``'s ``regimes``, ``epochs`` (the predictor's) and ``forecast_epochs``
(both backbones') default to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.cluster import make_trace
from repro_torch.core import forecast
from repro_torch.core.predictor import predict_batch, smape, train_predictor
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results, time_fn

SCALE = 120.0
BACKBONES = ("lstm", "mlstm")
REGIMES = ("steady_low", "fluctuating", "steady_high")


def run(quick: bool = False, *, device="cuda", regimes=REGIMES, epochs: int | None = None,
        forecast_epochs: int | None = None):
    dev = resolve_device(device)
    rows, payload = [], {}
    epochs = epochs or (4 if quick else 12)
    for kind in regimes:
        traces = [make_trace(kind, seed=s) for s in range(2 if quick else 4)]
        params = train_predictor(traces, scale=SCALE, epochs=epochs, seed=0,
                                 log=None, device=dev)
        err = smape(params, [make_trace(kind, seed=9)], scale=SCALE)

        # per-regime single-prediction latency on this regime's own params
        # (paper: < 50 ms) — min-of-k with the device synchronised in the clock
        hist = torch.as_tensor(make_trace(kind, seed=3)[:120], dtype=torch.float32,
                               device=dev)[None] / SCALE
        t = time_fn(torch.no_grad()(lambda p=params, h=hist: predict_batch(p, h)),
                    reps=20, warmup=2, device=dev)
        ms = t.best * 1e3
        payload[kind] = {"smape_pct": err, "predict_latency_ms": ms}
        rows.append(("fig3", f"smape_{kind}_pct", round(err, 2), "paper ~6%"))
        rows.append(("fig3", f"predict_latency_{kind}_ms", round(ms, 2),
                     "paper <50ms"))

    payload["forecast"] = {}
    fc_epochs = {"lstm": 3 if quick else 8, "mlstm": 5 if quick else 20}
    fc_lr = {"lstm": 5e-3, "mlstm": 3e-3}
    traces = [make_trace("fluctuating", seed=s)
              for s in range(2 if quick else 4)]
    eval_traces = [make_trace("fluctuating", seed=9)]
    for backbone in BACKBONES:
        params, ch = forecast.train_forecaster(
            traces, backbone=backbone, scale=SCALE,
            epochs=forecast_epochs or fc_epochs[backbone], lr=fc_lr[backbone], seed=0,
            device=dev)
        sm = forecast.smape_horizons(params, eval_traces, backbone=backbone,
                                     scale=SCALE, channel_scales=ch)
        pb = forecast.pinball_horizons(params, eval_traces, backbone=backbone,
                                       scale=SCALE, channel_scales=ch)
        X, _, _ = forecast.make_forecast_dataset(eval_traces, scale=SCALE,
                                                 channel_scales=ch)
        Xd = torch.as_tensor(X, device=dev)
        one = Xd[:1]
        call = torch.no_grad()(lambda h, p=params, b=backbone:
                               forecast.forecast_batch(p, h, backbone=b))
        t1 = time_fn(lambda: call(one), reps=20, warmup=2, device=dev)
        tb = time_fn(lambda: call(Xd), reps=5, warmup=1, device=dev)
        per_s = len(X) / tb.best
        payload["forecast"][backbone] = {
            "smape_pct": {str(h): v for h, v in sm.items()},
            "smape_mean_pct": float(np.mean(list(sm.values()))),
            "pinball_q90": {str(h): v for h, v in pb.items()},
            "predict_latency_ms": t1.best * 1e3,
            "predictions_per_s": per_s,
        }
        for h, v in sm.items():
            rows.append(("fig3", f"forecast_{backbone}_smape_{h}s_pct",
                         round(v, 2), "paper ~6% @20s"))
        rows.append(("fig3", f"forecast_{backbone}_predictions_per_s",
                     round(per_s, 0), ""))
    save_results("fig3_predictor", payload, device=device)
    return rows


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
