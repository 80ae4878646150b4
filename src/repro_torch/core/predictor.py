"""LSTM workload predictor (paper §IV-A, Fig. 3).

"predict the maximum workload for the next 20 seconds based on a time series
of loads per second collected over the past 2 minutes. The model architecture
includes a 25-unit LSTM layer followed by a one-unit dense output layer."

The dataset, the batch clamp, the permutations (``np.random.default_rng``)
and the cosine schedule are ``repro/core/predictor.py``'s; the network runs
on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.nn.linear import Linear, linear
from repro_torch.nn.lstm import LSTM, lstm_scan
from repro_torch.train import adamw_init, adamw_update

HISTORY = 120
HORIZON = 20
HIDDEN = 25


class Predictor(nn.Module):
    """``lstm`` (1 -> HIDDEN) and the dense ``out`` (HIDDEN -> 1). Trains."""

    def __init__(self, *, device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        self.lstm = LSTM(1, HIDDEN, device=device, generator=generator)
        self.out = Linear(HIDDEN, 1, bias=True, device=device, generator=generator)
        self.requires_grad_(True)


def init_predictor(seed: int, *, device="cuda") -> Predictor:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Predictor(device=dev, generator=gen)


def predict_batch(params: Predictor, hist):
    """hist [B, HISTORY] (normalised) -> predicted max load [B]."""
    _, (hT, _) = lstm_scan(params.lstm, hist[..., None])
    return linear(params.out, hT)[..., 0]


def make_dataset(traces: list[np.ndarray], *, scale: float):
    """Sliding windows -> (X [M, HISTORY], y [M]) normalised by ``scale``."""
    xs, ys = [], []
    for tr in traces:
        for s in range(0, len(tr) - HISTORY - HORIZON):
            xs.append(tr[s:s + HISTORY])
            ys.append(tr[s + HISTORY:s + HISTORY + HORIZON].max())
    X = np.asarray(xs, dtype=np.float32) / scale
    y = np.asarray(ys, dtype=np.float32) / scale
    return X, y


def _train_step(params: Predictor, opt: dict, xb, yb, lr: float):
    """One MSE step; returns (params, opt, loss) with ``params`` updated in
    place and ``loss`` left on the device."""
    loss = torch.mean((predict_batch(params, xb) - yb) ** 2)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    params, opt = adamw_update(params, dict(zip(names, grads, strict=True)), opt,
                               lr=lr, weight_decay=0.0)
    return params, opt, loss.detach()


def train_predictor(traces: list[np.ndarray], *, scale: float, epochs: int = 5,
                    batch: int = 256, seed: int = 0, lr: float = 5e-3, log=None,
                    device="cuda") -> Predictor:
    dev = resolve_device(device)
    X, y = make_dataset(traces, scale=scale)
    if len(X) == 0:
        raise ValueError(
            f"empty predictor dataset: need traces longer than "
            f"HISTORY + HORIZON = {HISTORY + HORIZON} s "
            f"(got {[len(t) for t in traces]})")
    # clamp so short traces still take gradient steps — an oversized batch
    # would make the step loop below empty and return untrained params
    batch = min(int(batch), len(X))
    rng = np.random.default_rng(seed)
    params = init_predictor(seed, device=dev)
    # start the output head at the target mean — removes the large constant
    # bias error the optimizer would otherwise spend epochs walking off
    with torch.no_grad():
        params.out.b += float(y.mean())
    opt = adamw_init(params)
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, device=dev)
    n_steps = max(1, (len(X) - batch + 1 + batch - 1) // batch) * epochs
    step = 0
    for e in range(epochs):
        idx = rng.permutation(len(X))
        losses = []
        for s in range(0, len(X) - batch + 1, batch):
            sel = torch.as_tensor(idx[s:s + batch], device=dev)
            # cosine decay to 10% of peak lr
            cur_lr = lr * (0.55 + 0.45 * np.cos(np.pi * step / n_steps))
            params, opt, loss = _train_step(params, opt, Xd[sel], yd[sel], cur_lr)
            losses.append(loss)
            step += 1
        if log:
            log(f"predictor epoch {e}: mse={np.mean(torch.stack(losses).tolist()):.5f}")
    return params


@torch.no_grad()
def smape(params: Predictor, traces: list[np.ndarray], *, scale: float) -> float:
    """Symmetric mean absolute percentage error (paper reports ~6%)."""
    X, y = make_dataset(traces, scale=scale)
    dev = params.out.w.device
    pred = predict_batch(params, torch.as_tensor(X, device=dev)).cpu().numpy()
    return float(np.mean(2.0 * np.abs(pred - y) /
                         (np.abs(pred) + np.abs(y) + 1e-9)) * 100.0)


def as_predictor_fn(params: Predictor, *, scale: float):
    """Adapter for PipelineEnv: load_history [HISTORY] -> predicted load.

    Advertises ``fn.min_history`` so callers can fall back to the
    last-observed load while the monitor window is still padded (see
    ``Monitor.valid``) — the model never trained on constant-padded input.
    """
    dev = params.out.w.device

    @torch.no_grad()
    def fn(hist: np.ndarray) -> float:
        h = torch.as_tensor(np.asarray(hist[-HISTORY:], np.float32),
                            device=dev)[None] / scale
        return float(predict_batch(params, h)[0]) * scale
    fn.min_history = HISTORY
    return fn
