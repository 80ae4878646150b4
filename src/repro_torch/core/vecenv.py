"""Vectorized rollout engine for OPD training on tensors.

Re-expresses the analytic ``PipelineEnv`` dynamics — Eq. (1)-(4)/(7) scoring,
arrival-trace windowing, and the policy's action -> config decoding — as
functions of f32 tensors on the trainer's device. Where
``repro/core/vecenv.py`` ``vmap``s one environment over seeds and
``lax.scan``s over time, every function here carries an explicit leading
env axis ``E`` and an episode is a Python loop over its ``n_steps``
adaptation intervals. The interval index ``t`` is a Python int shared by
all envs, so stepping never reads a value back from the device. The NumPy
``PipelineEnv`` stays the reference implementation (``tests/test_torch_vecenv.py``
pins step and reward equivalence between the two); ``core.runtime_vec`` is
the event-driven runtime's twin and reuses this module's placement.

Scope, mirroring exactly what the PPO training path constructs:

- no external load predictor (predicted load = current load), matching the
  envs built by ``Session.train``;
- per-task variant tables are padded to the max variant count and indexed
  modulo the true per-task count, matching ``policy.action_to_config``.

The env itself is deterministic given its trace — all rollout stochasticity
comes from the policy's sampling noise, drawn per environment from that
environment's own ``torch.Generator``, so rollouts are permutation-invariant
along the env axis. ``rollout`` and ``vec_rollout`` run under the twins'
sanitizer (``analysis.sanitize``) when it is on, as the reference's are
checkified.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np  # reprolint: ignore[RPL002] host-side table building and generator seeding only
import torch

from repro_torch.analysis import sanitize
from repro_torch.core.mdp import (ADAPTATION_INTERVAL, COLD_START_FRACTION,
                                  Pipeline, QoSWeights)
from repro_torch.core.policy import (Policy, apply_policy, gumbel_noise,
                                     select_actions)


class PipelineTables(NamedTuple):
    """A ``Pipeline``'s static physics as tensors ([N, V_max] per-variant
    attributes, padded by repeating each task's last variant).

    ``node_capacity`` / ``node_speed`` are **empty** ([0]) for a trivial
    (scalar-pool) topology — the empty shape selects the legacy code path in
    ``step``/``observe``, which skips placement entirely."""
    accuracy: torch.Tensor       # [N, V]  v_n(z)
    cost: torch.Tensor           # [N, V]  c_n(z)
    resource: torch.Tensor       # [N, V]  w_n(z)
    alpha: torch.Tensor          # [N, V]  fixed per-batch latency (s)
    beta: torch.Tensor           # [N, V]  per-item latency slope (s)
    n_variants: torch.Tensor     # [N]     true |Z_n| before padding
    batch_choices: torch.Tensor  # [nb]    the b knob's value set (1, 2, 4, ...)
    f_max: int
    b_max: int
    w_max: float                 # W_max
    node_capacity: torch.Tensor  # [K]     chips per node ([0] -> scalar pool)
    node_speed: torch.Tensor     # [K]     per-node service-rate factor
    hop_latency: float           # s per adjacent-stage cross-node hop (f32 value)

    @property
    def n_tasks(self) -> int:
        return self.accuracy.shape[0]

    @property
    def n_nodes(self) -> int:
        """Static node count; 0 means trivial topology (legacy physics)."""
        return self.node_capacity.shape[0]


class EnvState(NamedTuple):
    """``E`` analytic environments: interval index + live configurations."""
    t: int                       # adaptation-interval index, shared by all envs
    z: torch.Tensor              # [E, N] variant per task
    f: torch.Tensor              # [E, N] replicas per task
    b: torch.Tensor              # [E, N] batch size per task (actual value)


def tables_from_pipeline(pipe: Pipeline, *, device="cpu") -> PipelineTables:
    v_max = max(len(t.variants) for t in pipe.tasks)

    def tab(attr):
        rows = []
        for task in pipe.tasks:
            vals = [float(getattr(v, attr)) for v in task.variants]
            rows.append(vals + [vals[-1]] * (v_max - len(vals)))
        return torch.as_tensor(np.asarray(rows, np.float32), device=device)

    def f32(values):
        return torch.as_tensor(np.asarray(values, np.float32), device=device)

    if pipe.scalar_pool:
        node_capacity, node_speed, hop = f32([]), f32([]), 0.0
    else:
        topo = pipe.topo
        node_capacity = f32([n.capacity for n in topo.nodes])
        node_speed = f32([n.speed for n in topo.nodes])
        hop = float(np.float32(topo.hop_latency))

    return PipelineTables(
        accuracy=tab("accuracy"), cost=tab("cost"), resource=tab("resource"),
        alpha=tab("alpha"), beta=tab("beta"),
        n_variants=torch.as_tensor([len(t.variants) for t in pipe.tasks],
                                   device=device),
        batch_choices=torch.as_tensor(pipe.batch_choices(), device=device),
        f_max=int(pipe.f_max), b_max=int(pipe.b_max),
        w_max=float(np.float32(pipe.w_max)),
        node_capacity=node_capacity, node_speed=node_speed, hop_latency=hop)


def init_state(tables: PipelineTables, n_envs: int = 1) -> EnvState:
    """The default configuration every episode starts from (z=0, f=1, b=1)."""
    shape = (n_envs, tables.n_tasks)
    dev = tables.accuracy.device
    return EnvState(t=0, z=torch.zeros(shape, dtype=torch.int64, device=dev),
                    f=torch.ones(shape, dtype=torch.int64, device=dev),
                    b=torch.ones(shape, dtype=torch.int64, device=dev))


def decode_action(tables: PipelineTables, action: torch.Tensor):
    """Policy head indices [E, 3N] -> (z, f, b) [E, N]; the tensor twin of
    ``policy.action_to_config`` (modulo-clamped variants, f 1-based, batch
    looked up in the power-of-two choice set)."""
    action = action.long()
    z = action[:, 0::3] % tables.n_variants
    f = action[:, 1::3] + 1
    nb = tables.batch_choices.shape[0]
    b = tables.batch_choices[action[:, 2::3] % nb]
    return z, f, b


def _gather(table: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """table [N, V], z [E, N] -> per-task values [E, N]."""
    return torch.take_along_dim(table[None], z[..., None], dim=2)[..., 0]


class PlacementArrays(NamedTuple):
    """Result of the tensor first-fit scheduler, per env."""
    speed_sum: torch.Tensor      # [E, N] Σ node speed over the stage's replicas
    min_speed: torch.Tensor      # [E, N] slowest node hosting a replica
    primary: torch.Tensor        # [E, N] node with the most replicas (ties low)
    overflow: torch.Tensor       # [E]    force-placed resource shortfall
    rem: torch.Tensor            # [E, K] per-node remaining capacity
    slot_speed: torch.Tensor     # [E, N, f_max] node speed of each replica slot
                                 #   (1 for an inactive slot)


def _placement(tables: PipelineTables, z: torch.Tensor,
               f: torch.Tensor) -> PlacementArrays:
    """The tensor twin of ``cluster.topology``'s first-fit scheduler, taking
    identical discrete decisions (capacities and per-replica resources are
    integral chip counts, so every comparison is exact in float32).

    Unrolled over the static (n_tasks × f_max) replica slots; inactive slots
    (r >= f_n) are masked out, in the Python scheduler's assignment order, so
    replica slot ``r`` of stage ``i`` is ``Placement.nodes[i][r]`` and
    ``slot_speed`` mirrors ``RuntimeStage.replica_speeds``."""
    res = _gather(tables.resource, z)             # [E, N]
    E = z.shape[0]
    rem = tables.node_capacity.expand(E, -1).clone()
    speed = tables.node_speed
    overflow = torch.zeros(E, device=z.device)
    speed_sums, min_speeds, primaries, slot_rows = [], [], [], []
    for i in range(tables.n_tasks):
        w = res[:, i]
        s_sum = torch.zeros(E, device=z.device)
        s_min = torch.full((E,), float("inf"), device=z.device)
        counts = torch.zeros_like(rem, dtype=torch.int64)
        slots = []
        for r in range(tables.f_max):
            active = r < f[:, i]
            fits = rem >= w[:, None]
            idx = torch.where(fits.any(dim=1), torch.argmax(fits.to(torch.uint8), dim=1),
                              torch.argmax(rem, dim=1))
            take = torch.minimum(w, torch.gather(rem, 1, idx[:, None])[:, 0])
            amt = active.to(torch.float32)
            rem = rem.scatter_add(1, idx[:, None], (-take * amt)[:, None])
            overflow = overflow + (w - take) * amt
            sp = speed[idx]
            s_sum = s_sum + sp * amt
            s_min = torch.where(active, torch.minimum(s_min, sp), s_min)
            counts = counts.scatter_add(1, idx[:, None], active.long()[:, None])
            slots.append(torch.where(active, sp, 1.0))
        speed_sums.append(s_sum)
        min_speeds.append(torch.where(torch.isfinite(s_min), s_min, 1.0))
        primaries.append(torch.argmax(counts, dim=1))
        slot_rows.append(torch.stack(slots, 1))
    return PlacementArrays(speed_sum=torch.stack(speed_sums, 1),
                           min_speed=torch.stack(min_speeds, 1),
                           primary=torch.stack(primaries, 1),
                           overflow=overflow, rem=rem,
                           slot_speed=torch.stack(slot_rows, 1))


def observe_cfg(tables: PipelineTables, z: torch.Tensor, f: torch.Tensor,
                b: torch.Tensor, load: torch.Tensor) -> torch.Tensor:
    """Eq. (5) observation [E, N * 9] (plus one per-node free-capacity
    fraction per task row on a heterogeneous topology) for configurations
    (z, f, b) [E, N] under current load ``load`` [E] (req/s); predicted load
    = current load (the training envs attach no external predictor)."""
    fj, bj = f.to(torch.float32), b.to(torch.float32)
    E, n = z.shape
    usage = torch.sum(_gather(tables.resource, z) * fj, dim=1)
    u = (tables.w_max - usage) / tables.w_max
    p = load / 100.0
    lat = _gather(tables.alpha, z) + _gather(tables.beta, z) * bj
    thr = fj * bj / lat
    rows = torch.stack([
        u[:, None].expand(E, n), p[:, None].expand(E, n), p[:, None].expand(E, n),
        lat,
        thr / 100.0,
        z / torch.clamp(tables.n_variants - 1, min=1),
        fj / tables.f_max,
        bj / tables.b_max,
        fj * _gather(tables.cost, z) / tables.w_max,
    ], dim=2)
    if tables.n_nodes:                 # node status columns (heterogeneous)
        node_free = _placement(tables, z, f).rem / tables.node_capacity
        rows = torch.cat([rows, node_free[:, None, :].expand(E, n, -1)], dim=2)
    return rows.reshape(E, -1).to(torch.float32)


def observe(tables: PipelineTables, state: EnvState,
            traces: torch.Tensor) -> torch.Tensor:
    """Eq. (5) observations [E, D] of analytic env states: current load read
    from each env's trace [E, S] at the last second of the previous interval."""
    cur = traces[:, max(0, state.t * ADAPTATION_INTERVAL - 1)]
    return observe_cfg(tables, state.z, state.f, state.b, cur)


def step(tables: PipelineTables, state: EnvState, action: torch.Tensor,
         traces: torch.Tensor, weights: QoSWeights):
    """One adaptation interval of every env: decode ``action`` [E, 3N],
    apply the configuration, score Eq. (1)-(4)/(7) on the trace window.
    Deterministic given the traces. Returns (state', obs' [E, D],
    reward [E], metrics of [E])."""
    w = weights
    z, f, b = decode_action(tables, action)
    bf = b.to(torch.float32)
    fb = f.to(torch.float32) * bf

    s0 = state.t * ADAPTATION_INTERVAL
    demand = torch.mean(traces[:, s0:s0 + ADAPTATION_INTERVAL], dim=1)   # [E]
    d = demand[:, None]

    switched = (z != state.z).to(torch.float32)
    cold = COLD_START_FRACTION * torch.sum(switched, dim=1) / tables.n_tasks

    acc = _gather(tables.accuracy, z)
    cost = _gather(tables.cost, z)
    res = _gather(tables.resource, z)
    lat = _gather(tables.alpha, z) + _gather(tables.beta, z) * b

    v_sum = torch.sum(acc, dim=1)
    c_sum = torch.sum(cost * f, dim=1)
    # stage_latency: batch-assembly wait + M/M/1-style congested service
    wait = torch.clamp(fb / torch.clamp(d, min=1e-6), max=2.0)
    if tables.n_nodes == 0:            # scalar pool — legacy physics
        thr = fb / lat
        lat_eff = lat
        hop_total = 0.0
        infeasible = torch.sum(res * f, dim=1) > tables.w_max
    else:                              # placement-aware physics
        pl = _placement(tables, z, f)
        thr = pl.speed_sum * bf / lat
        lat_eff = lat / pl.min_speed
        n_hops = torch.sum((pl.primary[:, :-1] != pl.primary[:, 1:])
                           .to(torch.float32), dim=1)
        hop_total = tables.hop_latency * n_hops
        infeasible = pl.overflow > 0
    rho = d / torch.clamp(thr, min=1e-9)
    congestion = 1.0 / torch.clamp(1.0 - rho, min=0.1)
    lat_total = torch.sum(wait + lat_eff * congestion, dim=1) + hop_total

    capacity = torch.amin(thr, dim=1) * (1.0 - cold)
    excess = demand - capacity
    t_meas = torch.minimum(demand, capacity)

    qos = (w.alpha * v_sum + w.beta * t_meas - lat_total
           - torch.where(excess >= 0, w.gamma * excess, w.delta * (-excess)))
    reward = qos - w.beta_c * c_sum - w.gamma_b * torch.amax(b, dim=1)
    reward = reward - 50.0 * infeasible

    new_state = EnvState(t=state.t + 1, z=z, f=f, b=b)
    metrics = {"qos": qos, "cost": c_sum, "latency": lat_total,
               "throughput": t_meas, "excess": excess, "demand": demand,
               "capacity": capacity, "infeasible": infeasible}
    return new_state, observe(tables, new_state, traces), reward, metrics


def env_generators(seed: int, env_seeds, device) -> list[torch.Generator]:
    """One generator per env, seeded from (``seed``, the env's seed): the
    sampling noise of each env is its own."""
    gens = []
    for s in env_seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, s]).generate_state(1)[0]))
        gens.append(g)
    return gens


@sanitize.checked
@torch.no_grad()
def vec_rollout(params: Policy, tables: PipelineTables, traces: torch.Tensor,
                generators: list[torch.Generator] | None, *, n_steps: int,
                weights: QoSWeights, greedy: bool = False):
    """Parallel on-policy episodes, one per trace row [E, S]: select actions,
    step the envs, collect the PPO trajectory. Uses the same policy path as
    serving (``select_actions``). Returns env-major tensors
    [E, n_steps, ...] plus ``last_value`` [E]. Env ``i`` draws its sampling
    noise, all of it before the first step, from ``generators[i]`` alone,
    so permuting the env axis permutes the outputs; greedy decoding draws
    nothing."""
    n_envs = traces.shape[0]
    state = init_state(tables, n_envs)
    obs = observe(tables, state, traces)
    noise = None
    if not greedy:
        k = sum(h.w.shape[1] for h in params.heads)
        noise = torch.stack([gumbel_noise(g, (n_steps, k), traces.device)
                             for g in generators])          # [E, T, Σ s_i]
    steps = []
    for t in range(n_steps):
        logits, value = apply_policy(params, obs)
        action, logp = select_actions(logits, None if noise is None else noise[:, t])
        state, obs_next, r, metrics = step(tables, state, action, traces, weights)
        steps.append({"states": obs, "actions": action, "logps": logp,
                      "rewards": r, "values": value, **metrics})
        obs = obs_next
    traj = {k: torch.stack([s[k] for s in steps], dim=1) for k in steps[0]}
    _, traj["last_value"] = apply_policy(params, obs)
    return traj


@sanitize.checked
def rollout(params: Policy, tables: PipelineTables, trace: torch.Tensor,
            generator: torch.Generator | None, *, n_steps: int,
            weights: QoSWeights, greedy: bool = False):
    """One on-policy episode over ``trace`` [S]: ``vec_rollout`` of one env,
    returned without the env axis."""
    traj = vec_rollout(params, tables, trace[None], [generator], n_steps=n_steps,
                       weights=weights, greedy=greedy)
    return {k: v[0] for k, v in traj.items()}


def vec_gae(rewards: torch.Tensor, values: torch.Tensor, last_values: torch.Tensor,
            *, gamma: float, lam: float):
    """Batched GAE: [E, T] rewards/values, [E] bootstrap; the tensor twin of
    ``ppo.compute_gae``. Returns (advantages, returns) [E, T]."""
    gae = torch.zeros_like(last_values)
    v_next = last_values
    adv = []
    for t in reversed(range(rewards.shape[1])):
        delta = rewards[:, t] + gamma * v_next - values[:, t]
        gae = delta + gamma * lam * gae
        adv.append(gae)
        v_next = values[:, t]
    adv = torch.stack(adv[::-1], dim=1)
    return adv, adv + values


def gae_scan(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor,
             *, gamma: float, lam: float):
    """GAE over one episode [T]: ``vec_gae`` of one env."""
    adv, ret = vec_gae(rewards[None], values[None], torch.as_tensor(last_value, dtype=values.dtype,
                                                              device=values.device)[None],
                       gamma=gamma, lam=lam)
    return adv[0], ret[0]
