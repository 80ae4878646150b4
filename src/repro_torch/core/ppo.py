"""PPO with clipped surrogate objective (Eq. 11/12) + expert-guided episodes
(Algorithm 2). Optimiser: mini-batch Adam (paper: "Optimize the network by
mini-batch SGD with Adam optimizer").

Rollout collection has two engines:

- legacy loop: one NumPy ``PipelineEnv``/``RuntimeEnv`` stepped per Python
  iteration — the reference path, and the only one that can drive the
  expert (host-side coordinate descent);
- vectorized analytic (``num_envs > 1``): ``core.vecenv`` rolls
  ``num_envs`` analytic environments per episode as one batch of tensors on
  the trainer's device, with batched GAE;
- vectorized runtime (``vec_runtime`` arrivals factory): the
  ``core.runtime_vec`` discrete-event twin rolls closed-loop episodes on
  the *runtime* dynamics (queues, batch timeouts, cold starts) on the
  trainer's device, never constructing a per-env ``RuntimeEnv``
  (``launch/runtime_train_throughput.py`` measures it).

The policy and its optimiser state live on ``device`` (default ``"cuda"``);
minibatch permutations and behaviour-cloning draws come from the same
``np.random.default_rng(seed)`` stream as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np  # reprolint: ignore[RPL002] host-side batch assembly, GAE and logging only
import torch

from repro_torch.core import runtime_vec
from repro_torch.core.expert import ExpertPolicy
from repro_torch.core.mdp import ADAPTATION_INTERVAL, Pipeline, QoSWeights
from repro_torch.core.policy import (Policy, action_to_config, config_to_action,
                                     head_sizes, init_policy, log_prob_entropy,
                                     sample_action)
from repro_torch.core.vecenv import (env_generators, tables_from_pipeline,
                                     vec_gae, vec_rollout)
from repro_torch.device import resolve_device
from repro_torch.train import adamw_init, adamw_update, clip_by_global_norm

# vectorized env seeds start here so they never collide with the small
# integer seeds the legacy/expert episodes hand to make_env directly
VEC_SEED_BASE = 100_000


@dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    clip_eps: float = 0.2        # ε in Eq. (12)
    c1: float = 0.5              # value-loss coefficient (Eq. 11)
    c2: float = 0.01             # entropy-bonus coefficient (Eq. 11)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    epochs: int = 4
    minibatch: int = 64
    expert_freq: int = 4         # every f-th episode uses expert actions (Alg. 2)
    reward_scale: float = 0.05   # keeps value targets O(1) for stable VF learning
    # Alg. 2 keeps a replay memory D of expert transitions; we distil it into
    # the policy with a behaviour-cloning auxiliary loss each update.
    bc_coef: float = 0.3
    expert_buffer: int = 8192    # max expert (s, a) pairs retained in D


def compute_gae(rewards, values, last_value, *, gamma: float, lam: float):
    """Generalised advantage estimation over one episode."""
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    gae = 0.0
    for t in reversed(range(T)):
        v_next = last_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * v_next - values[t]
        gae = delta + gamma * lam * gae
        adv[t] = gae
    returns = adv + values
    return adv, returns


def ppo_minibatch_update(params: Policy, opt: dict, states, actions, old_logp,
                         adv, returns, bc_states, bc_actions, bc_coef: float,
                         *, clip_eps: float, c1: float, c2: float, lr: float):
    """One clipped-surrogate + value + entropy + behaviour-cloning step
    (Eq. 11), gradients clipped to global norm 0.5, AdamW without decay.
    Updates ``params`` in place; returns (params, opt, loss, l_clip, l_vf,
    l_ent) with the losses left on the device."""
    logp, ent, value = log_prob_entropy(params, states, actions)
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    l_clip = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
    l_vf = torch.mean((value - returns) ** 2)
    l_ent = torch.mean(ent)
    # behaviour cloning on the expert replay memory D (Alg. 2)
    bc_logp, _, _ = log_prob_entropy(params, bc_states, bc_actions)
    l_bc = -torch.mean(bc_logp)
    loss = l_clip + c1 * l_vf - c2 * l_ent + bc_coef * l_bc

    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    grads, _ = clip_by_global_norm(dict(zip(names, grads, strict=True)), 0.5)
    params, opt = adamw_update(params, grads, opt, lr=lr, weight_decay=0.0)
    return (params, opt, loss.detach(), l_clip.detach(), l_vf.detach(),
            l_ent.detach())


class OPDTrainer:
    """Algorithm 2: expert-guided PPO training of the OPD policy."""

    def __init__(self, pipe: Pipeline, make_env, *, ppo: PPOConfig | None = None,
                 weights: QoSWeights | None = None, seed: int = 0,
                 num_envs: int = 1, vec_runtime=None, device="cuda"):
        self.device = resolve_device(device)
        self.pipe = pipe
        self.make_env = make_env
        self.ppo = ppo or PPOConfig()
        self.expert = ExpertPolicy(pipe, weights)
        self.sizes = head_sizes(pipe)
        env = make_env(0)
        self.seed = seed
        self.params = init_policy(seed, env.state_dim, self.sizes, device=self.device)
        self.opt = adamw_init(self.params)
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed + 1)
        self.history = {"reward": [], "loss": [], "value_loss": [],
                        "policy_loss": [], "entropy": [], "expert": []}
        # replay memory D of expert transitions (Algorithm 2)
        self.expert_states = np.zeros((0, env.state_dim), np.float32)
        self.expert_actions = np.zeros((0, len(self.sizes)), np.int32)
        # vectorized rollout engines: core.vecenv for analytic envs without
        # an external predictor, core.runtime_vec (the discrete-event twin)
        # when a ``vec_runtime`` arrivals factory (seed -> ArrivalProcess)
        # is supplied; expert episodes always keep the legacy per-step loop
        self.num_envs = max(1, int(num_envs))
        self._vec_runtime = vec_runtime
        self._vec_ok = (self.num_envs > 1 and hasattr(env, "trace")
                        and getattr(env, "predictor", None) is None)
        self._tables = (tables_from_pipeline(pipe, device=self.device)
                        if self._vec_ok or vec_runtime is not None else None)
        self._weights = getattr(env, "w", None) or QoSWeights()
        if vec_runtime is not None:
            self._rt_horizon = int(getattr(env, "horizon", 120))
            self._rt_max_wait = float(getattr(env, "max_wait", runtime_vec.DEFAULT_MAX_WAIT))

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    @torch.no_grad()
    def _rollout(self, env, use_expert: bool):
        states, actions, logps, rewards, values = [], [], [], [], []
        s = env.reset()
        done = False
        while not done:
            s_t = self._tensor(s)
            if use_expert:
                cfg = self.expert.decide(env.observe())
                a = config_to_action(self.pipe, cfg)
                logp, _, v = log_prob_entropy(self.params, s_t[None],
                                              self._tensor(a)[None])
                logp, v = float(logp[0]), float(v[0])
            else:
                a_t, logp_t, v_t = sample_action(self.params, s_t, self.gen)
                a = a_t.cpu().numpy().astype(np.int32)
                cfg = action_to_config(self.pipe, a)
                logp, v = float(logp_t), float(v_t)
            s_next, r, done, info = env.step(cfg)
            states.append(s)
            actions.append(a)
            logps.append(logp)
            rewards.append(r)
            values.append(v)
            s = s_next
        _, _, last_v = log_prob_entropy(self.params, self._tensor(s)[None],
                                        self._tensor(actions[-1])[None])
        return (np.asarray(states, np.float32), np.asarray(actions, np.int32),
                np.asarray(logps, np.float32), np.asarray(rewards, np.float32),
                np.asarray(values, np.float32), float(last_v[0]))

    def _finish_vec(self, traj):
        """Batched GAE + flatten a [num_envs, T, ...] trajectory to the
        [num_envs * T] transition arrays ``_update`` consumes."""
        cfg = self.ppo
        adv, returns = vec_gae(traj["rewards"] * cfg.reward_scale,
                               traj["values"], traj["last_value"],
                               gamma=cfg.gamma, lam=cfg.gae_lambda)

        def flat(a):
            return a.reshape(-1, *a.shape[2:]).cpu().numpy()

        return (flat(traj["states"]).astype(np.float32),
                flat(traj["actions"]).astype(np.int32),
                flat(traj["logps"]).astype(np.float32),
                traj["rewards"].cpu().numpy().astype(np.float32),
                flat(adv).astype(np.float32),
                flat(returns).astype(np.float32))

    def _rollout_vec(self, base_seed: int):
        """Collect ``num_envs`` parallel episodes as one batch on the device.
        Env seeds are ``VEC_SEED_BASE + base_seed * num_envs + i`` — distinct
        traces per env, disjoint across episodes AND from the small
        legacy/expert episode seeds, so the expert replay memory never
        replays an on-policy trace. Returns flattened [num_envs * T]
        trajectory arrays + batched GAE."""
        s0 = VEC_SEED_BASE + base_seed * self.num_envs
        envs = [self.make_env(s0 + i) for i in range(self.num_envs)]
        n_steps = envs[0].n_steps
        if any(e.n_steps != n_steps for e in envs):
            raise ValueError("vectorized rollout needs equal-length traces")
        traces = self._tensor(np.stack([e.trace for e in envs]).astype(np.float32))
        # env i's sampling noise comes from its own generator, seeded from
        # (trainer seed, s0 + i)
        traj = vec_rollout(self.params, self._tables, traces,
                           env_generators(self.seed, range(s0, s0 + self.num_envs),
                                          self.device),
                           n_steps=n_steps,
                           weights=self._weights)
        return self._finish_vec(traj)

    def _rollout_vec_runtime(self, base_seed: int):
        """Collect ``num_envs`` closed-loop episodes on the discrete-event
        runtime twin (``core.runtime_vec``) on the trainer's device. Only
        the host-side arrival arrays are built per env; no ``RuntimeEnv``
        or ``ServingRuntime`` is constructed. Same seed discipline as
        ``_rollout_vec``."""
        s0 = VEC_SEED_BASE + base_seed * self.num_envs
        seeds = range(s0, s0 + self.num_envs)
        eps = runtime_vec.stack_episodes([
            runtime_vec.episode_arrivals(self._vec_runtime(s), self._rt_horizon)
            for s in seeds])
        traj = runtime_vec.vec_rollout(
            self.params, self._tables, eps, env_generators(self.seed, seeds, self.device),
            n_steps=max(1, self._rt_horizon // ADAPTATION_INTERVAL),
            weights=self._weights, max_wait=self._rt_max_wait)
        return self._finish_vec(traj)

    def _update(self, states, actions, logps, adv, returns):
        """Mini-batch Adam epochs over one batch of transitions (Eq. 11)."""
        cfg = self.ppo
        T = len(states)
        batch = [self._tensor(a) for a in (states, actions, logps, adv, returns)]
        expert = [self._tensor(self.expert_states), self._tensor(self.expert_actions)]
        out = []
        for _ in range(cfg.epochs):
            idx = self.rng.permutation(T)
            for s0 in range(0, T, cfg.minibatch):
                sel = self._tensor(idx[s0:s0 + cfg.minibatch])
                # sample a fixed-size BC batch from D (dummy + coef 0 until
                # the first expert episode fills it)
                if len(self.expert_states):
                    bsel = self._tensor(self.rng.integers(
                        0, len(self.expert_states), size=cfg.minibatch))
                    bc_s, bc_a = expert[0][bsel], expert[1][bsel]
                    bc_c = cfg.bc_coef
                else:
                    bc_s = batch[0][:1].expand(cfg.minibatch, -1)
                    bc_a = batch[1][:1].expand(cfg.minibatch, -1)
                    bc_c = 0.0
                s_b, a_b, lp_b, adv_b, ret_b = (x[sel] for x in batch)
                self.params, self.opt, *losses = ppo_minibatch_update(
                    self.params, self.opt, s_b, a_b, lp_b, adv_b, ret_b,
                    bc_s, bc_a, bc_c,
                    clip_eps=cfg.clip_eps, c1=cfg.c1, c2=cfg.c2, lr=cfg.lr)
                out.append(torch.stack(losses))
        losses, pls, vls, ents = torch.stack(out).T.tolist()
        return losses, pls, vls, ents

    def train_episode(self, episode_idx: int, *, env_seed: int | None = None):
        cfg = self.ppo
        use_expert = cfg.expert_freq > 0 and episode_idx % cfg.expert_freq == 0
        base = env_seed if env_seed is not None else episode_idx

        if self._vec_runtime is not None and not use_expert:
            states, actions, logps, rewards, adv, returns = \
                self._rollout_vec_runtime(base)
        elif self._vec_ok and not use_expert:
            states, actions, logps, rewards, adv, returns = \
                self._rollout_vec(base)
        else:
            # expert episodes stay on the legacy loop: the expert is a
            # host-side coordinate-descent search (Alg. 2)
            env = self.make_env(base)
            states, actions, logps, rewards, values, last_v = self._rollout(
                env, use_expert)
            adv, returns = compute_gae(rewards * cfg.reward_scale, values,
                                       last_v, gamma=cfg.gamma,
                                       lam=cfg.gae_lambda)
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        if use_expert:          # store in replay memory D (Alg. 2)
            self.expert_states = np.concatenate(
                [self.expert_states, states])[-cfg.expert_buffer:]
            self.expert_actions = np.concatenate(
                [self.expert_actions, actions])[-cfg.expert_buffer:]

        losses, pls, vls, ents = self._update(states, actions, logps, adv,
                                              returns)

        self.history["reward"].append(float(rewards.mean()))
        self.history["loss"].append(float(np.mean(losses)))
        self.history["policy_loss"].append(float(np.mean(pls)))
        self.history["value_loss"].append(float(np.mean(vls)))
        self.history["entropy"].append(float(np.mean(ents)))
        self.history["expert"].append(bool(use_expert))
        return self.history

    def train(self, n_episodes: int, *, log=None):
        for e in range(1, n_episodes + 1):
            self.train_episode(e)
            if log:
                log(f"episode {e}: reward={self.history['reward'][-1]:.3f} "
                    f"loss={self.history['loss'][-1]:.4f} "
                    f"vloss={self.history['value_loss'][-1]:.4f}"
                    + (" [expert]" if self.history["expert"][-1] else ""))
        return self.history
