"""Multi-discrete actor-critic policy network.

Action a_t = [(z_n, f_n, b_n)]_{n=1..N} (Eq. 6) -> one categorical head per
(task, knob). The feature extractor (residual blocks, features.py) is shared
between the actor heads and the value function. When the pipeline changes,
the head structure is rebuilt to match the new action space (paper: "When
the task changes, the action space must be modified").

Sampling is Gumbel-max over noise drawn from a caller's ``torch.Generator``:
the bits differ from ``jax.random.categorical``, the distribution does not,
and greedy decoding (argmax, first index on ties) is the reference's.
"""
from __future__ import annotations

import numpy as np  # reprolint: ignore[RPL002] host-side action<->config translation only
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.features import FEATURE_DIM, extract, init_features
from repro_torch.core.mdp import Config, Pipeline
from repro_torch.device import resolve_device
from repro_torch.nn.linear import Linear, linear


def head_sizes(pipe: Pipeline) -> tuple[int, ...]:
    """Per-task (|Z_n|, F_max, |batch choices|) flattened."""
    sizes = []
    nb = len(pipe.batch_choices())
    for task in pipe.tasks:
        sizes += [len(task.variants), pipe.f_max, nb]
    return tuple(sizes)


class Policy(nn.Module):
    """``features`` (ResMLP), one linear head per action knob (scale 0.01)
    and a scalar ``value`` head (scale 0.01). Its parameters train."""

    def __init__(self, state_dim: int, sizes: tuple[int, ...], *, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(bias=True, scale=0.01, device=device, generator=generator)
        self.features = init_features(state_dim, device=device, generator=generator)
        self.heads = nn.ModuleList(Linear(FEATURE_DIM, s, **kw) for s in sizes)
        self.value = Linear(FEATURE_DIM, 1, **kw)
        self.requires_grad_(True)


def init_policy(seed: int, state_dim: int, sizes: tuple[int, ...], *,
                device="cuda") -> Policy:
    """Random policy weights from ``seed`` on ``device`` (the reference's
    distributions, not its bits: parity tests carry the JAX weights in)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Policy(state_dim, sizes, device=dev, generator=gen)


def apply_policy(params: Policy, state):
    """state [B, D] -> (list of logits [B, s_i], value [B])."""
    feats = extract(params.features, state)
    logits = [linear(h, feats) for h in params.heads]
    value = linear(params.value, feats)[..., 0]
    return logits, value


def gumbel_noise(generator: torch.Generator, shape, device):
    """Gumbel(0, 1) noise from ``generator``: argmax(logits + noise) samples
    the categorical distribution of ``logits``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def select_actions(logits: list, noise=None):
    """Per-head argmax of ``logits`` (+ ``noise`` [B, Σ s_i] when sampling)
    -> (action indices [B, n_heads], summed log-prob [B])."""
    idxs, logps = [], []
    off = 0
    for lg in logits:
        s = lg.shape[-1]
        logp = F.log_softmax(lg, dim=-1)
        pick = lg if noise is None else lg + noise[:, off:off + s]
        idx = torch.argmax(pick, dim=-1)
        idxs.append(idx)
        logps.append(torch.gather(logp, -1, idx[:, None])[:, 0])
        off += s
    return torch.stack(idxs, dim=1), torch.stack(logps, dim=1).sum(dim=1)


def sample_action(params: Policy, state, generator: torch.Generator | None,
                  *, greedy: bool = False):
    """state [D] -> (action indices [n_heads], log_prob, value). Greedy
    decoding draws nothing from ``generator``."""
    logits, value = apply_policy(params, state[None])
    noise = None if greedy else gumbel_noise(
        generator, (1, sum(lg.shape[-1] for lg in logits)), state.device)
    idx, logp = select_actions(logits, noise)
    return idx[0], logp[0], value[0]


def log_prob_entropy(params: Policy, states, actions):
    """states [B, D]; actions [B, n_heads] -> (logp [B], entropy [B], value [B])."""
    logits, value = apply_policy(params, states)
    actions = actions.long()
    logp_total = 0.0
    ent_total = 0.0
    for i, lg in enumerate(logits):
        logp = F.log_softmax(lg, dim=-1)
        probs = torch.exp(logp)
        logp_total = logp_total + torch.gather(logp, -1, actions[:, i:i + 1])[:, 0]
        ent_total = ent_total - torch.sum(probs * logp, dim=-1)
    return logp_total, ent_total, value


def action_to_config(pipe: Pipeline, action: np.ndarray) -> Config:
    """Head indices [3N] -> Config, clamped to each task's variant count."""
    bc = pipe.batch_choices()
    z, f, b = [], [], []
    for n, task in enumerate(pipe.tasks):
        zi = int(action[3 * n]) % len(task.variants)
        fi = int(action[3 * n + 1]) + 1
        bi = bc[int(action[3 * n + 2]) % len(bc)]
        z.append(zi)
        f.append(fi)
        b.append(bi)
    return Config(z=tuple(z), f=tuple(f), b=tuple(b))


def config_to_action(pipe: Pipeline, cfg: Config) -> np.ndarray:
    """Inverse of action_to_config (for expert trajectories)."""
    bc = pipe.batch_choices()
    out = []
    for n in range(pipe.n_tasks):
        out += [cfg.z[n], cfg.f[n] - 1, bc.index(cfg.b[n])]
    return np.asarray(out, dtype=np.int32)
