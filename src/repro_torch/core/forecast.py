"""Multi-horizon load forecasting (paper §IV-A, upgraded per ROADMAP).

The paper's predictor emits ONE number — the max load over the next 20 s.
Proactive control needs more: to pre-warm a variant whose cold start takes
``COLD_START_SECONDS``, the controller must see the burst *at least* a cold
start ahead; to arbitrate fleet capacity it wants the load over exactly the
next adaptation interval. This module generalises the predictor into a
multi-horizon forecaster emitting, from one shared backbone pass, the max
load over each horizon in ``HORIZONS`` = {5, 10, 20, 60} s.

Two backbones share the training loop, dataset windowing and eval:

- ``"lstm"``  — the paper-faithful 25-unit LSTM (``nn.lstm``) + dense head;
- ``"mlstm"`` — an xLSTM matrix-memory block (``nn.xlstm.mlstm_parallel``,
  parallelisable over the 120 s window) over an embedded load sequence,
  with a residual + RMSNorm read-out at the last position.

Port of ``repro/core/forecast.py``. The dataset windowing, the telemetry
trace, the batch clamp, the permutations (``np.random.default_rng``), the
cosine schedule and the output-bias start are the reference's NumPy, bit
for bit; the networks train and forecast on ``device`` (default
``"cuda"``), eagerly: the LSTM is a Python loop over the window, as
``nn/lstm.lstm_scan`` is. The parameter names are the reference pytree's,
so ``models.convert.load_jax_params`` carries its weights across.

``as_forecast_fn`` adapts trained params to the closed loop: the returned
callable maps a load history to one prediction per horizon and advertises
``.horizons`` / ``.min_history`` so environments can fall back to the
last-observed load until a full window of real measurements exists (the
Monitor left-pads cold histories with a constant — a distribution the
forecaster never trained on).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.nn.linear import Linear, linear
from repro_torch.nn.lstm import LSTM, lstm_scan
from repro_torch.nn.norms import RMSNorm, rmsnorm
from repro_torch.nn.xlstm import MLSTM, mlstm_parallel
from repro_torch.train import adamw_init, adamw_update

HISTORY = 120                  # seconds of load history per window (paper: 2 min)
HORIZONS = (5, 10, 20, 60)     # forecast horizons (s): prewarm lead times,
#                                the adaptation interval, the paper's 20 s
MLSTM_DIM = 16                 # mLSTM backbone model dim (2 heads, expand 2)
MLSTM_HEADS = 2

BACKBONES = ("lstm", "mlstm")


# ------------------------------------------------------------- dataset ----


def make_forecast_dataset(traces, *, history: int = HISTORY,
                          horizons: tuple[int, ...] = HORIZONS,
                          scale: float, channel_scales=None):
    """Sliding telemetry windows -> (X [M, history, C], y [M, H]).

    ``traces`` is a list of [T] load arrays or [T, C] telemetry arrays
    (channel 0 = load). Targets are the max of channel 0 over each future
    window ``(t, t+h]``. Channel 0 is normalised by ``scale``; extra
    channels by ``channel_scales`` (default: per-channel max over the
    training data, clamped >= 1). Returns the channel scales actually used
    so eval/serving normalise identically."""
    horizons = tuple(int(h) for h in horizons)
    hmax = max(horizons)
    mats = [np.asarray(tr, dtype=np.float32).reshape(len(tr), -1)
            for tr in traces]
    C = mats[0].shape[1]
    if any(m.shape[1] != C for m in mats):
        raise ValueError("all traces must have the same channel count")
    if channel_scales is None:
        rest = (np.maximum([np.abs(m[:, 1:]).max(axis=0) for m in mats],
                           1.0).max(axis=0) if C > 1 else np.empty(0))
        channel_scales = np.concatenate([[scale], rest]).astype(np.float32)
    channel_scales = np.asarray(channel_scales, dtype=np.float32)
    xs, ys = [], []
    for m in mats:
        for s in range(0, len(m) - history - hmax + 1):
            xs.append(m[s:s + history])
            fut = m[s + history:s + history + hmax, 0]
            ys.append([fut[:h].max() for h in horizons])
    X = np.asarray(xs, dtype=np.float32) / channel_scales
    y = np.asarray(ys, dtype=np.float32) / channel_scales[0]
    return X, y, channel_scales


def telemetry_trace(runtime, *, seconds: int | None = None) -> np.ndarray:
    """Assemble a [T, 1 + 2*n_stages] training trace from a live runtime's
    telemetry: per-second arrivals (channel 0), per-stage mean queue depth
    at dispatch, and per-stage utilization (service-seconds charged per
    second per replica). Seconds with no dispatch carry the last observed
    queue depth forward (0 before the first)."""
    tel = runtime.telemetry
    T = int(seconds if seconds is not None else np.ceil(runtime.now))
    S = len(runtime.stages)
    out = np.zeros((T, 1 + 2 * S), dtype=np.float32)
    out[:, 0] = tel.load_history(T, T)
    depth_sum = np.zeros((T, S))
    depth_cnt = np.zeros((T, S))
    for b in tel.batches:
        s = int(b.time)
        if 0 <= s < T:
            depth_sum[s, b.stage] += b.queue_depth
            depth_cnt[s, b.stage] += 1
            out[s, 1 + S + b.stage] += b.service
    last = np.zeros(S)
    for s in range(T):
        for i in range(S):
            if depth_cnt[s, i]:
                last[i] = depth_sum[s, i] / depth_cnt[s, i]
            out[s, 1 + i] = last[i]
    for i, stage in enumerate(runtime.stages):
        out[:, 1 + S + i] /= max(stage.replicas, 1)
    return out


# -------------------------------------------------------------- model ----


class Forecaster(nn.Module):
    """One backbone + a dense head with one unit per horizon. ``lstm``:
    ``{lstm, out}``; ``mlstm``: ``{embed, mlstm, norm, out}`` — the
    reference pytree's keys. Trains (its parameters require grad)."""

    def __init__(self, *, backbone: str = "lstm", in_dim: int = 1,
                 horizons: tuple[int, ...] = HORIZONS, hidden: int = 25,
                 dim: int = MLSTM_DIM, n_heads: int = MLSTM_HEADS,
                 device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        H = len(horizons)
        kw = dict(device=device, generator=generator)
        if backbone == "lstm":
            self.lstm = LSTM(in_dim, hidden, **kw)
            self.out = Linear(hidden, H, bias=True, **kw)
        elif backbone == "mlstm":
            self.embed = Linear(in_dim, dim, bias=True, **kw)
            self.mlstm = MLSTM(dim, n_heads, **kw)
            self.norm = RMSNorm(dim, device=device)
            self.out = Linear(dim, H, bias=True, **kw)
        else:
            raise ValueError(f"unknown backbone {backbone!r} (one of: {BACKBONES})")
        self.requires_grad_(True)


def init_forecaster(seed: int, *, backbone: str = "lstm", in_dim: int = 1,
                    horizons: tuple[int, ...] = HORIZONS, hidden: int = 25,
                    dim: int = MLSTM_DIM, n_heads: int = MLSTM_HEADS,
                    device="cuda") -> Forecaster:
    """A ``Forecaster`` on ``device``, its weights drawn from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Forecaster(backbone=backbone, in_dim=in_dim, horizons=horizons,
                      hidden=hidden, dim=dim, n_heads=n_heads, device=dev,
                      generator=gen)


def forecast_batch(params: Forecaster, x, *, backbone: str = "lstm",
                   n_heads: int = MLSTM_HEADS):
    """x [B, history, C] (normalised) -> predicted max loads [B, H]."""
    if backbone == "lstm":
        _, (hT, _) = lstm_scan(params.lstm, x)
        return linear(params.out, hT)
    h = linear(params.embed, x)
    h = h + mlstm_parallel(params.mlstm, h, n_heads=n_heads)
    return linear(params.out, rmsnorm(params.norm, h[:, -1]))


def _train_step(params: Forecaster, opt: dict, xb, yb, lr: float, *, backbone: str,
                n_heads: int):
    """One MSE step; returns (params, opt, loss) with ``params`` updated in
    place and ``loss`` left on the device."""
    loss = torch.mean((forecast_batch(params, xb, backbone=backbone,
                                      n_heads=n_heads) - yb) ** 2)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    params, opt = adamw_update(params, dict(zip(names, grads, strict=True)), opt,
                               lr=lr, weight_decay=0.0)
    return params, opt, loss.detach()


def train_forecaster(traces, *, backbone: str = "lstm", scale: float,
                     horizons: tuple[int, ...] = HORIZONS,
                     history: int = HISTORY, hidden: int = 25,
                     dim: int = MLSTM_DIM, n_heads: int = MLSTM_HEADS,
                     epochs: int = 8, batch: int = 256, seed: int = 0,
                     lr: float = 5e-3, log=None, device="cuda"):
    """Shared training loop for both backbones (MSE on normalised targets,
    cosine lr decay, output bias started at the per-horizon target mean),
    on ``device``. Returns ``(params, channel_scales)``. Raises on an empty
    dataset; the batch size is clamped to the dataset so short traces
    still train."""
    dev = resolve_device(device)
    X, y, channel_scales = make_forecast_dataset(
        traces, history=history, horizons=horizons, scale=scale)
    if len(X) == 0:
        raise ValueError(
            f"empty forecast dataset: need traces longer than "
            f"history + max(horizons) = {history + max(horizons)} s")
    batch = min(int(batch), len(X))
    rng = np.random.default_rng(seed)
    params = init_forecaster(seed, backbone=backbone, in_dim=X.shape[-1],
                             horizons=horizons, hidden=hidden, dim=dim,
                             n_heads=n_heads, device=dev)
    with torch.no_grad():
        params.out.b += torch.as_tensor(y.mean(axis=0), device=dev)
    opt = adamw_init(params)
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, device=dev)
    steps_per_epoch = max(1, (len(X) - batch) // batch + 1)
    n_steps = steps_per_epoch * epochs
    step = 0
    for e in range(epochs):
        idx = rng.permutation(len(X))
        losses = []
        for s in range(0, len(X) - batch + 1, batch):
            sel = torch.as_tensor(idx[s:s + batch], device=dev)
            cur_lr = lr * (0.55 + 0.45 * np.cos(np.pi * step / n_steps))
            params, opt, loss = _train_step(params, opt, Xd[sel], yd[sel], cur_lr,
                                            backbone=backbone, n_heads=n_heads)
            losses.append(loss)
            step += 1
        if log:
            log(f"forecaster[{backbone}] epoch {e}: "
                f"mse={np.mean(torch.stack(losses).tolist()):.5f}")
    return params, channel_scales


# ---------------------------------------------------------------- eval ----


@torch.no_grad()
def _predict(params: Forecaster, X: np.ndarray, *, backbone: str, n_heads: int):
    dev = params.out.w.device
    return forecast_batch(params, torch.as_tensor(X, device=dev), backbone=backbone,
                          n_heads=n_heads).cpu().numpy()


def smape_horizons(params: Forecaster, traces, *, backbone: str = "lstm", scale: float,
                   horizons: tuple[int, ...] = HORIZONS,
                   history: int = HISTORY, n_heads: int = MLSTM_HEADS,
                   channel_scales=None) -> dict[int, float]:
    """Per-horizon symmetric MAPE (%) on held-out traces (paper: ~6%)."""
    X, y, _ = make_forecast_dataset(traces, history=history,
                                    horizons=horizons, scale=scale,
                                    channel_scales=channel_scales)
    pred = _predict(params, X, backbone=backbone, n_heads=n_heads)
    err = (2.0 * np.abs(pred - y)
           / (np.abs(pred) + np.abs(y) + 1e-9)).mean(axis=0) * 100.0
    return {int(h): float(e) for h, e in zip(horizons, err, strict=True)}


def pinball_horizons(params: Forecaster, traces, *, q: float = 0.9,
                     backbone: str = "lstm", scale: float,
                     horizons: tuple[int, ...] = HORIZONS,
                     history: int = HISTORY, n_heads: int = MLSTM_HEADS,
                     channel_scales=None) -> dict[int, float]:
    """Per-horizon quantile (pinball) loss of the point forecast at level
    ``q`` — penalises under-forecasts ``q/(1-q)``× more than over-forecasts,
    the asymmetry that matters when an under-forecast means a missed
    pre-warm. Reported in load units (de-normalised)."""
    X, y, _ = make_forecast_dataset(traces, history=history,
                                    horizons=horizons, scale=scale,
                                    channel_scales=channel_scales)
    pred = _predict(params, X, backbone=backbone, n_heads=n_heads)
    diff = (y - pred) * scale
    loss = np.maximum(q * diff, (q - 1.0) * diff).mean(axis=0)
    return {int(h): float(v) for h, v in zip(horizons, loss, strict=True)}


# ------------------------------------------------------------- serving ----


def as_forecast_fn(params: Forecaster, *, scale: float, backbone: str = "lstm",
                   horizons: tuple[int, ...] = HORIZONS,
                   history: int = HISTORY, n_heads: int = MLSTM_HEADS,
                   channel_scales=None):
    """Adapter for the envs: load/telemetry history -> one predicted max
    load per horizon (np.ndarray [H], de-normalised). The fn advertises
    ``.horizons`` and ``.min_history`` so callers (``_ConfigEnvBase``,
    ``FleetRuntime``) can fall back to the last-observed load until a full
    window of real measurements exists. It runs on the params' device: the
    window goes there and the [H] forecast comes back, one synchronisation
    per call. It also keeps ``.params``, ``.scale`` and ``.channel_scales``,
    so a caller can evaluate or copy the trained network it wraps."""
    scales = (np.asarray(channel_scales, dtype=np.float32)
              if channel_scales is not None
              else np.asarray([scale], dtype=np.float32))
    dev = params.out.w.device

    @torch.no_grad()
    def fn(hist: np.ndarray) -> np.ndarray:
        h = np.asarray(hist, dtype=np.float32).reshape(len(hist), -1)
        h = h[-history:] / scales[:h.shape[1]]
        pred = forecast_batch(params, torch.as_tensor(h, device=dev)[None],
                              backbone=backbone, n_heads=n_heads)
        return pred[0].cpu().numpy() * scale

    fn.horizons = tuple(int(h) for h in horizons)
    fn.min_history = int(history)
    fn.backbone = backbone
    fn.params, fn.scale, fn.channel_scales = params, float(scale), scales
    return fn
