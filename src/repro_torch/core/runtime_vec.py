"""Tensor twin of the discrete-event serving runtime.

Port of ``repro/core/runtime_vec.py``. ``serving.runtime.ServingRuntime``
steps a Python ``heapq`` one event at a time: exact, but single-env. This
module re-expresses the same dynamics as an event loop over f32 times and
int32 indices on the trainer's device, with an explicit leading env axis
``E``: a closed-loop adaptation episode (a policy decision every
``ADAPTATION_INTERVAL``, the measured-telemetry reward of Eq. (3)/(7)) is a
Python loop over intervals, each of which advances every env's event loop
to the interval's end.

The dynamics are the reference's, line for line. Each stage's next
dispatch instant is derived from its queue state (timeout-or-full
continuous batching, cold-start gate, free-replica gate) and the loop
processes the earliest of

  dispatch < completion

(ties break by ``argmin`` over ``[dispatch..., completion...]``, dispatches
first). Arrivals and transfer deliveries are not events: stage 0's queue
is a head pointer into the sorted arrival array (laid into queue-buffer row
0), and a forwarded completion writes its batch into the next stage's
append-only queue at once, stamped with its delivery time ``now + hop``.
In-flight batches pin their head index (``fl_head``), so the buffer sees
exactly one write per event (the forward enqueue, one ``index_put_``);
everything else is gathers and masked vector math on the carried per-stage
head and batch-full stamps (``r_head`` / ``r_full``, refreshed from the
buffer once per interval). A completion replays the dispatch timers on the
post-completion state and, when some stage is due at that instant,
processes that dispatch in the same iteration. Placement reuses
``vecenv._placement``, whose discrete decisions equal the Python first-fit
scheduler's, so slot speeds and hops match ``ServingRuntime``.

Where the reference stops its ``lax.while_loop`` on
``any(next_event <= t_end)``, every such test here is a read from the
device. Envs mask their own effects (an env whose next event lies past
``t_end`` is a no-op, and the pick it recomputes is discarded at the end of
the interval), so the loop runs ``CHECK_EVERY`` iterations between tests:
exact, with one host read per block. On a CUDA device a block of
iterations is captured once in a CUDA graph and replayed (``capture``); on
the CPU it runs eagerly.

Exact and approximate as the reference: event ordering, batch formation,
replica claiming, service times, cold starts, placement and transfer
stamps are exact; times are float32, so a completion within ~1e-4 s of an
interval boundary may count one interval over (served counts within a
request or two of ``RuntimeEnv``; ``tests/test_torch_runtime_vec.py`` pins
both against ``ServingRuntime`` and against the reference twin).
``vec_rollout`` and ``replay`` run under the twins' sanitizer
(``analysis.sanitize``, NaN and division checks, as the reference's) when
it is on; a replayed graph would bypass its checks, so ``capture`` is then
off and the event loop runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np  # reprolint: ignore[RPL002] host-side arrival-array prep only (episode_arrivals/stack_episodes)
import torch

from repro_torch.analysis import sanitize
from repro_torch.core.mdp import ADAPTATION_INTERVAL, COLD_START_FRACTION, QoSWeights
from repro_torch.core.policy import Policy, apply_policy, gumbel_noise, select_actions
from repro_torch.core.vecenv import (PipelineTables, _gather, _placement, decode_action,
                                     observe_cfg)

INF = float("inf")
COLD_START_SECONDS = COLD_START_FRACTION * ADAPTATION_INTERVAL
DEFAULT_MAX_WAIT = 0.25          # mirrors serving.runtime.DEFAULT_MAX_WAIT
_ARRIVAL_BUCKET = 512            # arrival arrays pad to multiples of this
# guaranteed inf-padding at the tail of every arrival array, so the event
# loop's 2B-wide head window is always in bounds (2 * b_max <= _ARRIVAL_PAD,
# checked in init_state)
_ARRIVAL_PAD = 64
# event-loop iterations between two tests for the interval's end (one host
# read each); extra iterations are no-ops
CHECK_EVERY = 16


class EpisodeArrivals(NamedTuple):
    """One episode's pre-generated arrival stream plus the per-interval
    statistics the reward and observation need (computed in float64 from
    the exact times, as the Python telemetry counts them). CPU tensors;
    ``stack_episodes`` adds the leading env axis."""
    times: torch.Tensor      # [N_cap] f32 arrival instants, padded with inf
    arrived: torch.Tensor    # [T] f32  arrivals in [10k, 10k+10)
    load_obs: torch.Tensor   # [T] f32  measured load at decision k (req/s)


class RuntimeState(NamedTuple):
    """The twin's event-loop state, every field with a leading env axis E."""
    now: torch.Tensor        # [E] f32 virtual clock
    arr_idx: torch.Tensor    # [E] i32 arrivals landed by the last boundary
    q_buf: torch.Tensor      # [E, S, Q, 2] f32 append-only queue:
                             #   [..., 0] original arrival time
                             #   [..., 1] delivery time at this stage
                             #   (row 0 holds the arrival array in both)
    q_head: torch.Tensor     # [E, S] i32 (monotone; head 0 indexes arrivals)
    q_len: torch.Tensor      # [E, S] i32 enqueued requests
    r_head: torch.Tensor     # [E, S] f32 head delivery stamp
    r_full: torch.Tensor     # [E, S] f32 stamp of the b-th queued request
    fl_finish: torch.Tensor  # [E, S, R] f32 in-flight finish time (inf = free)
    fl_size: torch.Tensor    # [E, S, R] i32 pinned batch size
    fl_head: torch.Tensor    # [E, S, R] i32 queue index of the batch's head
    blocked: torch.Tensor    # [E, S] f32 cold-start gate
    z: torch.Tensor          # [E, S] i32 live variant
    f: torch.Tensor          # [E, S] i32 live replicas
    b: torch.Tensor          # [E, S] i32 live batch size
    slot_speed: torch.Tensor  # [E, S, R] f32 node speed of each replica slot
    hop_next: torch.Tensor   # [E, S] f32 transfer delay stage s -> s+1 (last 0)
    completed: torch.Tensor  # [E] f32 completions this interval
    lat_sum: torch.Tensor    # [E] f32 Σ end-to-end latency this interval
    events: torch.Tensor     # [E] i32 events processed so far (a counter the
                             #   throughput benchmark reads; not in the reference)


# ---------------------------------------------------------------- episode --

def episode_arrivals(process, horizon: int, *, n_cap: int | None = None) -> EpisodeArrivals:
    """Host-side precomputation of one episode's arrivals: the shared
    ``process.times(horizon)`` array (what ``ServingRuntime.load``
    consumes) padded to a bucketed capacity, plus float64 per-interval
    arrival counts and the per-second measured load the predictor-free
    observation reads (``RuntimeEnv`` prefills its monitor with the t=0
    expected rate; afterwards the newest monitor slot is the arrival count
    of the second before each decision). NumPy, bit for bit the reference's."""
    t = np.asarray(process.times(horizon), np.float64)
    n_steps = max(1, int(horizon) // ADAPTATION_INTERVAL)
    edges = np.arange(n_steps + 1, dtype=np.float64) * ADAPTATION_INTERVAL
    arrived = np.histogram(t, bins=edges)[0].astype(np.float64)
    load_obs = np.empty(n_steps, np.float64)
    load_obs[0] = float(process.rates(1)[0])
    for k in range(1, n_steps):
        s = k * ADAPTATION_INTERVAL - 1
        load_obs[k] = np.count_nonzero((t >= s) & (t < s + 1))
    if n_cap is None:
        n_cap = (int(np.ceil((len(t) + _ARRIVAL_PAD) / _ARRIVAL_BUCKET))
                 * _ARRIVAL_BUCKET)
    if len(t) > n_cap - _ARRIVAL_PAD:
        raise ValueError(f"n_cap={n_cap} < {len(t)} arrivals + pad")
    padded = np.full(n_cap, np.inf, np.float32)
    padded[:len(t)] = t.astype(np.float32)
    return EpisodeArrivals(times=torch.from_numpy(padded),
                           arrived=torch.from_numpy(arrived.astype(np.float32)),
                           load_obs=torch.from_numpy(load_obs.astype(np.float32)))


def stack_episodes(eps: list[EpisodeArrivals]) -> EpisodeArrivals:
    """Batch per-env episodes along a leading axis (re-padding arrival
    arrays to the widest bucket) for ``vec_rollout``."""
    n_cap = max(e.times.shape[0] for e in eps)
    times = np.full((len(eps), n_cap), np.inf, np.float32)
    for i, e in enumerate(eps):
        times[i, :e.times.shape[0]] = e.times.numpy()
    return EpisodeArrivals(times=torch.from_numpy(times),
                           arrived=torch.stack([e.arrived for e in eps]),
                           load_obs=torch.stack([e.load_obs for e in eps]))


def to_device(eps: EpisodeArrivals, device) -> EpisodeArrivals:
    return EpisodeArrivals(*(t.to(device) for t in eps))


# ------------------------------------------------------------------ state --

def init_state(tables: PipelineTables, eps: EpisodeArrivals) -> RuntimeState:
    """Episode start of every env of ``eps`` (times [E, N_cap], on the
    tables' device): default configuration (z=0, f=1, b=1) already placed,
    empty queues, idle replicas, as ``RuntimeEnv.reset``."""
    S, R, B = tables.n_tasks, tables.f_max, tables.b_max
    if 2 * B > _ARRIVAL_PAD:
        raise ValueError(f"2*b_max={2 * B} exceeds arrival padding {_ARRIVAL_PAD}")
    E, n_cap = eps.times.shape
    dev = eps.times.device
    # every request enqueues at each stage exactly once, so the append-only
    # buffer needs arrival capacity + one batch of write headroom
    Q = n_cap + B
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    z0 = torch.zeros((E, S), **i32)
    f0 = torch.ones((E, S), **i32)
    slot_speed, hop_next = _install_placement(tables, z0, f0)
    # stage 0's queue row holds the (inf-padded) arrival array in both
    # columns; the last B lanes stay inf, where masked-off enqueue writes land
    q_buf = torch.zeros((E, S, Q, 2), **f32)
    q_buf[:, 0] = INF
    q_buf[:, 0, :n_cap, 0] = eps.times
    q_buf[:, 0, :n_cap, 1] = eps.times
    return RuntimeState(
        now=torch.zeros(E, **f32), arr_idx=torch.zeros(E, **i32), q_buf=q_buf,
        q_head=torch.zeros((E, S), **i32), q_len=torch.zeros((E, S), **i32),
        r_head=torch.full((E, S), INF, **f32), r_full=torch.full((E, S), INF, **f32),
        fl_finish=torch.full((E, S, R), INF, **f32),
        fl_size=torch.zeros((E, S, R), **i32), fl_head=torch.zeros((E, S, R), **i32),
        blocked=torch.zeros((E, S), **f32), z=z0, f=f0, b=torch.ones((E, S), **i32),
        slot_speed=slot_speed, hop_next=hop_next,
        completed=torch.zeros(E, **f32), lat_sum=torch.zeros(E, **f32),
        events=torch.zeros(E, **i32))


def _install_placement(tables: PipelineTables, z: torch.Tensor, f: torch.Tensor):
    """(slot_speed [E, S, R], hop_next [E, S]) of configurations (z, f)
    [E, S]: the twin of ``ServingRuntime._install_placement``."""
    E, S = z.shape
    dev = z.device
    if tables.n_nodes == 0:            # scalar pool: unit speed, no hops
        return (torch.ones((E, S, tables.f_max), dtype=torch.float32, device=dev),
                torch.zeros((E, S), dtype=torch.float32, device=dev))
    pl = _placement(tables, z.long(), f.long())
    hop = torch.where(pl.primary[:, :-1] != pl.primary[:, 1:],
                      tables.hop_latency, 0.0).to(torch.float32)
    return pl.slot_speed, torch.cat([hop, torch.zeros((E, 1), dtype=torch.float32,
                                                      device=dev)], dim=1)




# -------------------------------------------------------------- event loop --

class EventLoop:
    """The event loop of one rollout: ``advance`` is the twin of
    ``ServingRuntime.run_until`` for every env at once.

    It owns the per-interval constants as device tensors (``t_end``,
    ``max_wait``, and ``cpack``: each stage's batch size, replica count,
    cold-start gate and service coefficients, fixed between
    reconfigurations), so a block of ``CHECK_EVERY`` iterations captured in
    a CUDA graph reads them at replay. ``capture=True`` (CUDA only)
    captures the block on the first interval and replays it after."""

    def __init__(self, tables: PipelineTables, n_envs: int, max_wait: float, *,
                 device, capture: bool = False):
        dev = torch.device(device)
        if capture and dev.type != "cuda":
            raise ValueError(f"capture needs a CUDA device, not {dev}")
        S, R, B = tables.n_tasks, tables.f_max, tables.b_max
        self.tables, self.S, self.R, self.B = tables, S, R, B
        self.capture = capture
        self.t_end = torch.zeros((), dtype=torch.float32, device=dev)
        self.max_wait = torch.tensor(max_wait, dtype=torch.float32, device=dev)
        self.cpack = torch.zeros((n_envs, 5, S), dtype=torch.float32, device=dev)
        # int64, as the indices an index kernel takes: an int32 state index
        # plus an iota promotes without a conversion of its own
        self.iota_s = torch.arange(S, device=dev)
        self.iota_r = torch.arange(R, device=dev)
        self.iota_b = torch.arange(B, device=dev)
        self.iota_b2 = torch.arange(2 * B, device=dev)
        self.envs = torch.arange(n_envs, device=dev)
        self.stage0 = self.iota_s == 0
        self.graph = None
        self.blocks = 0               # blocks run (one host read each)

    # -- the reference's refresh / select / body_env, with the env axis ------

    def refresh(self, st: RuntimeState) -> RuntimeState:
        """Recompute the carried head / batch-full delivery stamps from the
        queue buffer, once per interval (a reconfiguration can change b).
        The inf tails keep head + b - 1 in bounds."""
        Q = st.q_buf.shape[2]
        env, s = self.envs[:, None], self.iota_s[None, :]
        return st._replace(
            r_head=st.q_buf[env, s, torch.clamp(st.q_head, max=Q - 1), 1],
            r_full=st.q_buf[env, s, torch.clamp(st.q_head + st.b - 1, max=Q - 1), 1])

    def _t_disp(self, now, q_len, r_head, r_full, b, in_flight, f):
        """Each stage's next dispatch instant [E, S] (inf while no replica is
        free): batch-full and timeout instants derive from delivery stamps,
        so future arrivals and in-flight transfers schedule dispatches
        without being events themselves."""
        has_any = torch.where(self.stage0, r_head < INF, q_len > 0)
        # max with the head stamp: strict-FIFO popping cannot start a batch
        # before its head delivers
        t_full = torch.where(self.stage0 | (q_len >= b), torch.maximum(r_full, r_head), INF)
        t_ready = torch.minimum(t_full, torch.where(has_any, r_head + self.max_wait, INF))
        t_disp = torch.maximum(now[:, None], torch.maximum(self.cpack[:, 2], t_ready))
        return torch.where(in_flight < f, t_disp, INF)

    def _pick(self, t_disp, fl_finish):
        """Every env's earliest pending event (t, is_completion, s_disp,
        s_cmp, r_cmp): one argmin over [S + S*R] candidates, dispatches
        first, so the first-occurrence tie-break keeps the
        dispatch-before-completion priority."""
        S, R = self.S, self.R
        t, idx = torch.min(torch.cat([t_disp, fl_finish.flatten(1)], dim=1), dim=1)
        cmp_flat = torch.clamp(idx - S, min=0)
        return (t, idx >= S, torch.clamp(idx, max=S - 1),
                torch.div(cmp_flat, R, rounding_mode="floor"), cmp_flat % R)

    def select(self, st: RuntimeState):
        in_flight = torch.sum(st.fl_finish < INF, dim=2)
        return self._pick(self._t_disp(st.now, st.q_len, st.r_head, st.r_full, st.b,
                                       in_flight, st.f), st.fl_finish)

    def body(self, st: RuntimeState, sel):
        """One event of every env whose next event lies at or before
        ``t_end``. Every effect is masked, so a drained env is a no-op
        while its siblings catch up."""
        S, B = self.S, self.B
        Q = st.q_buf.shape[2]
        e, env = self.envs, self.envs[:, None]
        now, ev, s_disp, s_cmp, r_cmp = sel
        active = now <= self.t_end
        is_cmp = active & ev

        # -- completion: free the slot; the final stage -> telemetry, else
        #    the batch enters the next stage's queue at once, stamped with
        #    its delivery time (now + hop)
        k_cmp = st.fl_size[e, s_cmp, r_cmp]
        # the batch's arrival times still sit where they were dispatched
        # from (the buffer is append-only): one gather recovers them
        hd_cmp = st.fl_head[e, s_cmp, r_cmp]
        cmp_orig = st.q_buf[env, s_cmp[:, None], hd_cmp[:, None] + self.iota_b, 0]
        last = s_cmp == S - 1
        oh_cmp = ((self.iota_s[None, :, None] == s_cmp[:, None, None])
                  & (self.iota_r[None, None, :] == r_cmp[:, None, None]))
        fl_finish = torch.where(is_cmp[:, None, None] & oh_cmp, INF, st.fl_finish)
        done = is_cmp & last
        k_f = k_cmp.to(torch.float32)
        completed = st.completed + torch.where(done, k_f, 0.0)
        lat = k_f * now - torch.sum(torch.where(self.iota_b < k_cmp[:, None], cmp_orig, 0.0),
                                    dim=1)
        lat_sum = st.lat_sum + torch.where(done, lat, 0.0)
        forward = is_cmp & ~last
        w_s = torch.clamp(s_cmp + 1, max=S - 1)
        deliver = now + st.hop_next[e, s_cmp]

        # -- the one write on the buffer: a forwarded completion puts its
        #    batch into s+1 as B contiguous lanes (lanes past the batch land
        #    beyond the new tail and are overwritten before any read).
        #    Masked-off events write at (0, Q - B), the inf headroom past
        #    stage 0's arrivals, which no window read reaches
        tail = st.q_head[e, w_s] + st.q_len[e, w_s]
        row = torch.where(forward, w_s, 0)
        start = torch.where(forward, tail, Q - B)
        st.q_buf[env, row[:, None], start[:, None] + self.iota_b] = torch.stack(
            [cmp_orig, deliver[:, None].expand(-1, B)], dim=-1)

        # -- completion -> dispatch fusion: replay the dispatch timers on the
        #    post-completion state; a stage due at this very instant is
        #    provably the globally-next event, processed in this iteration
        enq = forward[:, None] & (self.iota_s[None, :] == w_s[:, None])
        q_len_mid = st.q_len + torch.where(enq, k_cmp[:, None], 0)
        r_head_mid = torch.where(enq & (st.q_len == 0), deliver[:, None], st.r_head)
        r_full_mid = torch.where(enq & (st.q_len < st.b) & (q_len_mid >= st.b),
                                 deliver[:, None], st.r_full)
        in_flight = torch.sum(fl_finish < INF, dim=2)
        t_disp = self._t_disp(now, q_len_mid, r_head_mid, r_full_mid, st.b, in_flight, st.f)
        t_min, s_next = torch.min(t_disp, dim=1)
        fused = is_cmp & (t_min <= now)
        s_disp = torch.where(ev, s_next, s_disp)
        is_disp = (active & ~ev) | fused

        # -- dispatch: pop the delivered FIFO prefix (clamped to b), claim
        #    the fastest free slot; stage 0 pops straight out of the arrival
        #    array's head window
        seld = self.cpack[e, :, s_disp]                              # [E, 5]
        b_d = seld[:, 0].long()
        f_d = seld[:, 1].long()
        head_d = st.q_head[e, s_disp]
        qlen_d = q_len_mid[e, s_disp]
        stamp = st.q_buf[env, s_disp[:, None], head_d[:, None] + self.iota_b2, 1]   # [E, 2B]
        # stage 0's depth is virtual: its lanes past the arrivals are inf
        in_q = (s_disp == 0)[:, None] | (self.iota_b2 < qlen_d[:, None])
        # the delivered prefix: the first undelivered lane bounds the pop
        ready = (stamp <= now[:, None]) & in_q
        n_avail = torch.cumprod(ready, dim=1).sum(dim=1)
        n_pop = torch.where(is_disp, torch.minimum(b_d, n_avail), 0)
        n_pop32 = n_pop.to(torch.int32)
        free = (self.iota_r < f_d[:, None]) & (fl_finish[e, s_disp] == INF)
        best, r_claim = torch.max(torch.where(free, st.slot_speed[e, s_disp], -INF), dim=1)
        service = (seld[:, 3] + seld[:, 4] * n_pop) / torch.clamp(best, min=1e-9)
        oh_disp = is_disp[:, None] & (self.iota_s[None, :] == s_disp[:, None])
        claim = oh_disp[:, :, None] & (self.iota_r[None, None, :] == r_claim[:, None, None])
        fl_finish = torch.where(claim, (now + service)[:, None, None], fl_finish)
        # pin where the batch came from, not what it contained
        fl_size = torch.where(claim, n_pop32[:, None, None], st.fl_size)
        fl_head = torch.where(claim, head_d[:, None, None], st.fl_head)

        # -- head/len bookkeeping (stage 0's len is virtual, rebuilt after
        #    the loop) and the dispatching stage's new head and batch-full
        #    stamps, straight out of its window (n_pop <= b <= B)
        q_head = st.q_head + torch.where(oh_disp, n_pop32[:, None], 0)
        q_len = q_len_mid - torch.where(oh_disp & ~self.stage0, n_pop32[:, None], 0)
        rhf = torch.gather(stamp, 1, torch.stack([n_pop, n_pop + b_d - 1], dim=1))
        st = st._replace(
            now=torch.where(active, torch.maximum(st.now, now), st.now),
            q_head=q_head, q_len=q_len,
            r_head=torch.where(oh_disp, rhf[:, :1], r_head_mid),
            r_full=torch.where(oh_disp, rhf[:, 1:], r_full_mid),
            fl_finish=fl_finish, fl_size=fl_size, fl_head=fl_head,
            completed=completed, lat_sum=lat_sum, events=st.events + active + fused)

        # -- incremental next-event pick: a dispatch changes only its own
        #    stage's timer; patch that one and redo the argmin (for an idle
        #    env the previous pick is reproduced)
        q_len_d = qlen_d - torch.where(s_disp > 0, n_pop, 0)
        has_any_d = torch.where(s_disp == 0, rhf[:, 0] < INF, q_len_d > 0)
        t_full_d = torch.where((s_disp == 0) | (q_len_d >= b_d),
                               torch.maximum(rhf[:, 1], rhf[:, 0]), INF)
        t_ready_d = torch.minimum(t_full_d,
                                  torch.where(has_any_d, rhf[:, 0] + self.max_wait, INF))
        t_disp_d = torch.maximum(now, torch.maximum(seld[:, 2], t_ready_d))
        t_disp_d = torch.where(in_flight[e, s_disp] + 1 < f_d, t_disp_d, INF)
        return st, self._pick(torch.where(oh_disp, t_disp_d[:, None], t_disp), fl_finish)

    def _block(self, st: RuntimeState, sel):
        for _ in range(CHECK_EVERY):
            st, sel = self.body(st, sel)
        return st, sel

    def _pending(self, sel) -> bool:
        """The loop's exit test, one read from the device."""
        return bool((sel[0] <= self.t_end).any())

    # -- captured blocks --------------------------------------------------------

    def _capture(self, st: RuntimeState, sel) -> None:
        """Capture one block on static buffers (warmed up on copies first:
        the body writes the queue buffer in place)."""
        self.g_state = RuntimeState(*(t.clone() for t in st))
        self.g_sel = tuple(t.clone() for t in sel)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._block(RuntimeState(*(t.clone() for t in st)), tuple(t.clone() for t in sel))
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out, out_sel = self._block(self.g_state, self.g_sel)
            for dst, src in zip(self.g_state + self.g_sel, out + out_sel):
                if dst is not src:
                    dst.copy_(src)

    def _run_captured(self, st: RuntimeState, sel) -> RuntimeState:
        if self.graph is None or self.g_state.q_buf.shape != st.q_buf.shape:
            self._capture(st, sel)
        for dst, src in zip(self.g_state + self.g_sel, st + sel):
            dst.copy_(src)
        while True:
            self.graph.replay()
            self.blocks += 1
            if not self._pending(self.g_sel):
                break
        # copies: the next interval's replays overwrite the static buffers
        return RuntimeState(*(t.clone() for t in self.g_state))

    def advance(self, state: RuntimeState, times: torch.Tensor, t_end: float) -> RuntimeState:
        """Process every event with time <= ``t_end``, leaving every env's
        clock at ``t_end``. ``times`` [E, N_cap] are the envs' arrivals."""
        self.t_end.fill_(t_end)
        z = state.z.long()
        self.cpack.copy_(torch.stack([state.b.to(torch.float32), state.f.to(torch.float32),
                                      state.blocked, _gather(self.tables.alpha, z),
                                      _gather(self.tables.beta, z)], dim=1))
        st = self.refresh(state)
        sel = self.select(st)
        if self.capture:
            st = self._run_captured(st, sel)
        else:
            while True:
                st, sel = self._block(st, sel)
                self.blocks += 1
                if not self._pending(sel):
                    break
        # materialise stage 0's virtual queue depth at the interval boundary
        E = times.shape[0]
        n_seen = torch.searchsorted(times, self.t_end.expand(E, 1).contiguous(),
                                    right=True)[:, 0].to(torch.int32)
        q_len = st.q_len.clone()
        q_len[:, 0] = n_seen - st.q_head[:, 0]
        return st._replace(now=torch.clamp(st.now, min=t_end), arr_idx=n_seen, q_len=q_len)


# ----------------------------------------------------------------- interval --

def _analytic_latency(tables: PipelineTables, z, f, b, demand):
    """Twin of ``mdp.analytic_pipeline_latency`` [E]: the smooth latency
    fallback when an interval completes nothing. z, f, b [E, S] (int64)."""
    bf = b.to(torch.float32)
    fb = f.to(torch.float32) * bf
    lat = _gather(tables.alpha, z) + _gather(tables.beta, z) * bf
    wait = torch.clamp(fb / torch.clamp(demand, min=1e-6)[:, None], max=2.0)
    if tables.n_nodes == 0:
        thr = fb / lat
        lat_eff = lat
        hop_total = 0.0
    else:
        pl = _placement(tables, z, f)
        thr = pl.speed_sum * bf / lat
        lat_eff = lat / pl.min_speed
        n_hops = torch.sum((pl.primary[:, :-1] != pl.primary[:, 1:]).to(torch.float32), dim=1)
        hop_total = tables.hop_latency * n_hops
    rho = demand[:, None] / torch.clamp(thr, min=1e-9)
    congestion = 1.0 / torch.clamp(1.0 - rho, min=0.1)
    return torch.sum(wait + lat_eff * congestion, dim=1) + hop_total


def _apply_config(tables: PipelineTables, state: RuntimeState,
                  action: torch.Tensor) -> RuntimeState:
    """Decode and install every env's configuration at an interval boundary
    (cold start in virtual time, re-placement, telemetry reset): the first
    half of ``RuntimeEnv.step``. In-flight transfers keep the delivery
    stamps they departed with."""
    z, f, b = (x.to(torch.int32) for x in decode_action(tables, action))
    blocked = torch.where(z != state.z,
                          torch.maximum(state.blocked, (state.now + COLD_START_SECONDS)[:, None]),
                          state.blocked)
    slot_speed, hop_next = _install_placement(tables, z, f)
    zero = torch.zeros_like(state.completed)
    return state._replace(z=z, f=f, b=b, blocked=blocked, slot_speed=slot_speed,
                          hop_next=hop_next, completed=zero, lat_sum=zero)


def _score(tables: PipelineTables, state: RuntimeState, arrived: torch.Tensor,
           weights: QoSWeights):
    """Score every env's measured interval telemetry with Eq. (3)/(7): the
    second half of ``RuntimeEnv.step``. Returns (reward [E], metrics)."""
    w = weights
    z, f, b = state.z.long(), state.f.long(), state.b.long()
    demand = arrived / ADAPTATION_INTERVAL
    T = state.completed / ADAPTATION_INTERVAL
    L = torch.where(state.completed > 0,
                    state.lat_sum / torch.clamp(state.completed, min=1.0),
                    _analytic_latency(tables, z, f, b, torch.clamp(demand, min=1.0)))
    E = demand - T
    V = torch.sum(_gather(tables.accuracy, z), dim=1)
    C = torch.sum(_gather(tables.cost, z) * f.to(torch.float32), dim=1)
    qos = (w.alpha * V + w.beta * T - L
           - torch.where(E >= 0, w.gamma * E, w.delta * (-E)))
    reward = qos - w.beta_c * C - w.gamma_b * torch.amax(state.b, dim=1)
    if tables.n_nodes == 0:
        res = _gather(tables.resource, z)
        infeasible = torch.sum(res * f.to(torch.float32), dim=1) > tables.w_max
    else:
        infeasible = _placement(tables, z, f).overflow > 0
    reward = reward - 50.0 * infeasible
    metrics = {"qos": qos, "cost": C, "latency": L, "throughput": T,
               "excess": E, "demand": demand, "completed": state.completed,
               "infeasible": infeasible, "queue_depths": state.q_len,
               "backlog": _backlog(state)}
    return reward, metrics


def interval_step(tables: PipelineTables, state: RuntimeState, action: torch.Tensor,
                  k: int, ep: EpisodeArrivals, weights: QoSWeights, loop: EventLoop):
    """One adaptation interval of the closed loop across the env axis: the
    twin of ``RuntimeEnv.step``. Decode and apply each env's configuration
    (``action`` [E, 3N]), advance ``loop`` to the interval's end, score each
    env's measured telemetry. ``k`` is the shared interval index. Returns
    (state', rewards [E], metrics)."""
    state = _apply_config(tables, state, action)
    state = loop.advance(state, ep.times, float((k + 1) * ADAPTATION_INTERVAL))
    reward, metrics = _score(tables, state, ep.arrived[:, k], weights)
    return state, reward, metrics


def _backlog(state: RuntimeState) -> torch.Tensor:
    """Requests admitted but not yet fully served [E] (queued, in transfer,
    or in flight): the twin of ``ServingRuntime.in_system``. In-transfer
    batches already sit in their destination queue, so q_len covers them."""
    in_fl = torch.sum(torch.where(state.fl_finish < INF, state.fl_size, 0), dim=(1, 2))
    return (torch.sum(state.q_len, dim=1) + in_fl).to(torch.float32)


# ------------------------------------------------------------------ rollout --

def _use_graphs(dev: torch.device, capture: bool | None) -> bool:
    """Blocks in CUDA graphs: by default on a CUDA device, never while the
    sanitizer is on (a replayed graph bypasses the dispatcher)."""
    if sanitize.enabled():
        return False
    return dev.type == "cuda" if capture is None else capture


def _observe(tables: PipelineTables, state: RuntimeState, load: torch.Tensor):
    return observe_cfg(tables, state.z.long(), state.f.long(), state.b.long(), load)


@sanitize.checked(errors=sanitize.NAN_DIV_ERRORS)
@torch.no_grad()
def vec_rollout(params: Policy, tables: PipelineTables, eps: EpisodeArrivals,
                generators: list[torch.Generator] | None, *, n_steps: int,
                weights: QoSWeights, max_wait: float = DEFAULT_MAX_WAIT,
                greedy: bool = False, capture: bool | None = None):
    """Parallel closed-loop episodes on the runtime twin, one per env of
    ``eps`` (``stack_episodes``): sample each env's action, advance the
    batched event loop, collect PPO trajectories [E, T, ...] plus
    ``last_value`` [E] on the tables' device. Env ``i`` draws its sampling
    noise, all of it before the first step, from ``generators[i]`` alone
    and consumes only its own arrivals, so permuting the env axis permutes
    the outputs; greedy decoding draws nothing. ``capture`` (the event
    loop's blocks in CUDA graphs) defaults to True on a CUDA device."""
    dev = tables.accuracy.device
    eps = to_device(eps, dev)
    E = eps.times.shape[0]
    loop = EventLoop(tables, E, max_wait, device=dev,
                     capture=_use_graphs(dev, capture))
    state = init_state(tables, eps)
    obs = _observe(tables, state, eps.load_obs[:, 0])
    noise = None
    if not greedy:
        width = sum(h.w.shape[1] for h in params.heads)
        noise = torch.stack([gumbel_noise(g, (n_steps, width), dev) for g in generators])
    steps = []
    for k in range(n_steps):
        logits, value = apply_policy(params, obs)
        action, logp = select_actions(logits, None if noise is None else noise[:, k])
        state, r, metrics = interval_step(tables, state, action, k, eps, weights, loop)
        obs_next = _observe(tables, state, eps.load_obs[:, min(k + 1, n_steps - 1)])
        steps.append({"states": obs, "actions": action, "logps": logp, "rewards": r,
                      "values": value, "qos": metrics["qos"],
                      "completed": metrics["completed"]})
        obs = obs_next
    traj = {k: torch.stack([s[k] for s in steps], dim=1) for k in steps[0]}
    _, traj["last_value"] = apply_policy(params, obs)
    traj["events"] = state.events
    traj["blocks"] = loop.blocks
    return traj


def rollout(params: Policy, tables: PipelineTables, ep: EpisodeArrivals,
            generator: torch.Generator | None, *, n_steps: int, weights: QoSWeights,
            max_wait: float = DEFAULT_MAX_WAIT, greedy: bool = False):
    """One on-policy closed-loop episode on the twin: ``vec_rollout`` of one
    env, returned without the env axis."""
    traj = vec_rollout(params, tables, stack_episodes([ep]), [generator], n_steps=n_steps,
                       weights=weights, max_wait=max_wait, greedy=greedy)
    return {k: (v[0] if isinstance(v, torch.Tensor) else v) for k, v in traj.items()}


@sanitize.checked(errors=sanitize.NAN_DIV_ERRORS)
@torch.no_grad()
def replay(tables: PipelineTables, ep: EpisodeArrivals, actions: torch.Tensor, *,
           n_steps: int, weights: QoSWeights, max_wait: float = DEFAULT_MAX_WAIT,
           capture: bool | None = None):
    """Drive the twin with a fixed action sequence [T, 3N] (policy head
    indices) and return per-interval rewards and measured metrics [T, ...]:
    the equivalence hook the tests hold against ``RuntimeEnv`` stepping the
    same decisions."""
    dev = tables.accuracy.device
    eps = to_device(stack_episodes([ep]), dev)
    loop = EventLoop(tables, 1, max_wait, device=dev,
                     capture=_use_graphs(dev, capture))
    state = init_state(tables, eps)
    actions = torch.as_tensor(actions, device=dev)
    out = []
    for k in range(n_steps):
        state, r, metrics = interval_step(tables, state, actions[k][None], k, eps,
                                          weights, loop)
        out.append({"rewards": r, **metrics})
    return {key: torch.stack([o[key] for o in out])[:, 0] for key in out[0]}
