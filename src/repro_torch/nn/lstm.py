"""Plain LSTM (for the OPD workload predictor — paper §IV-A: 25-unit LSTM
followed by a one-unit dense layer).

Gates are ``i, f, g, o`` in that order along the ``4H`` axis, the forget
gate takes ``sigmoid(f + 1.0)``, ``wh`` has no bias and h0 = c0 = 0, as in
``repro/nn/lstm.py``. The input projection of every step is one product
over the whole sequence; the recurrence is a Python loop over time."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.linear import Linear, linear


class LSTM(nn.Module):
    def __init__(self, in_dim: int, hidden: int, *, dtype=torch.float32,
                 device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wx = Linear(in_dim, 4 * hidden, bias=True, **kw)
        self.wh = Linear(hidden, 4 * hidden, **kw)

    def forward(self, x):
        return lstm_scan(self, x)


def lstm_scan(params: LSTM, x):
    """x [B, T, in_dim] -> (h_seq [B, T, H], (h_T, c_T))."""
    B, T, _ = x.shape
    H = params.wh.w.shape[0]
    zx = linear(params.wx, x)                       # [B, T, 4H]
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = h
    hs = []
    for t in range(T):
        z = zx[:, t] + linear(params.wh, h)
        i, f, g, o = torch.split(z, H, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)
