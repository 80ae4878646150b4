"""Event-driven, clock-stepped serving runtime.

A virtual-time event loop drives requests from pluggable arrival processes
(`serving.arrivals`) through per-stage continuous batchers (timeout-or-full
dispatch, actual batch sizes — no tail padding) and replica pools. Per-batch
service times are charged from the analytic perf model (each stage's
`core.mdp.ModelVariant` latency curve, built by `cluster.perf_model`), with
optional real PyTorch execution through a stage ``executor`` (e.g.
`serving.engine.StageServer.execute`, on the GPU the hand-written Hopper
kernels) so outputs flow through live models while virtual time stays
deterministic: an executor never moves the virtual clock.

The OPD control loop closes over this runtime: ``apply_config`` is the live
reconfiguration (paper: Kubernetes API) — a variant switch blocks the stage
for ``COLD_START_SECONDS`` of virtual time (container re-pull / weight
re-shard), replica and batch knobs take effect immediately. The
`cluster.env.RuntimeEnv` adapter exposes the same MDP interface the analytic
simulator does, scored from measured telemetry.

Event ordering is deterministic: ties in virtual time break by insertion
sequence (FIFO), so identical seeds reproduce identical schedules.

The event heap itself lives in an :class:`EventLoop` that a runtime either
owns privately (the classic single-pipeline case) or shares with other
runtimes — a multi-tenant fleet (:mod:`serving.fleet`) hosts N pipelines on
one loop, interleaving their events in one deterministic virtual timeline.

NumPy, ``heapq`` and plain Python, as in ``repro/serving/runtime.py``: the
same seed gives the same schedule, batch log and summary bit for bit. A
live executor's batch is a ``tracing`` span (``runtime.batch``).
"""
from __future__ import annotations

import heapq
import itertools

import numpy as np

from repro_torch import tracing
from repro_torch.core.mdp import Config, Pipeline, Task, placement_for
from repro_torch.serving.batcher import ContinuousBatcher, Request, stack_tokens
from repro_torch.serving.telemetry import Telemetry

# Virtual-time cost of a variant switch: the paper's cold start loses
# COLD_START_FRACTION (0.3) of a 10 s adaptation interval's capacity.
COLD_START_SECONDS = 3.0
DEFAULT_MAX_WAIT = 0.25   # s a request may wait before a partial batch fires


class EventLoop:
    """A virtual-time event heap shared by one or more runtimes.

    Each pushed event carries its owning runtime; ``run_until`` pops events
    in (time, insertion-sequence) order and routes them back to the owner's
    ``_handle``. The insertion sequence is global across owners, so a fleet
    of runtimes sharing one loop interleaves deterministically — and a loop
    with a single owner behaves exactly like the historical private heap.
    """

    def __init__(self):
        self.now = 0.0
        self.events = 0               # total events processed (fleet events/s)
        self._heap: list[tuple] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, t: float, owner, kind: str, payload):
        # owner sits *after* payload: seq is unique, so comparisons never
        # reach it (runtimes are not orderable)
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload, owner))

    def next_time(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def run_until(self, t_end: float):
        """Process all events with time <= t_end; clock lands on t_end."""
        while self._heap and self._heap[0][0] <= t_end + 1e-12:
            t, _, kind, payload, owner = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            self.events += 1
            owner._handle(kind, payload)
        self.now = max(self.now, t_end)

    def drain(self):
        """Run the loop dry — every admitted request completes."""
        while self._heap:
            self.run_until(self._heap[0][0])


class RuntimeStage:
    """One pipeline stage: variant timing models, a continuous batcher and a
    replica pool. ``executor(z, tokens[B, S]) -> outputs [B, S]`` optionally
    runs a real model; otherwise stage output = input tokens.

    Replicas live on cluster nodes (``replica_nodes`` / ``replica_speeds``
    from the placement scheduler): a dispatch claims the fastest free
    replica, whose node speed scales the batch's service time and whose node
    is charged the replica-seconds."""

    def __init__(self, name: str, task: Task, *, z: int = 0, replicas: int = 1,
                 batch_size: int = 1, max_wait: float = DEFAULT_MAX_WAIT,
                 seq_len: int = 32, executor=None):
        self.name = name
        self.task = task
        self.z = int(z) % len(task.variants)
        self.replicas = max(1, int(replicas))
        self.replica_nodes: tuple[int, ...] = (0,) * self.replicas
        self.replica_speeds: tuple[float, ...] = (1.0,) * self.replicas
        self.batcher = ContinuousBatcher(batch_size, max_wait=max_wait)
        self.seq_len = seq_len
        self.executor = executor
        self.in_flight = 0
        self._busy: set[int] = set()  # replica indices currently serving
        self.blocked_until = 0.0      # cold-start gate (virtual s)
        self.warm_z: int | None = None  # variant being pre-warmed off-path
        self.warm_ready = 0.0           # virtual time its cold start finishes
        self.busy_time = 0.0          # Σ replica-seconds of service charged
        self.served = 0
        self._pending_timer: float | None = None
        # replica-seconds integral (replicas change across reconfigs)
        self._cap_accum = 0.0
        self._cap_since = 0.0

    @property
    def var(self):
        return self.task.variants[self.z]

    def service_time(self, batch: int, speed: float = 1.0) -> float:
        return self.var.latency(batch) / speed

    def claim_replica(self) -> int:
        """The fastest free replica index (ties -> lowest index). Callers
        must hold ``in_flight < replicas``, which guarantees a free one."""
        free = [r for r in range(self.replicas) if r not in self._busy]
        idx = max(free, key=lambda r: (self.replica_speeds[r], -r))
        self._busy.add(idx)
        return idx

    def release_replica(self, idx: int):
        self._busy.discard(idx)

    def set_replicas(self, replicas: int, now: float,
                     nodes: tuple[int, ...] | None = None,
                     speeds: tuple[float, ...] | None = None):
        self._cap_accum += (now - self._cap_since) * self.replicas
        self._cap_since = now
        self.replicas = max(1, int(replicas))
        self.replica_nodes = (tuple(nodes) if nodes is not None
                              else (0,) * self.replicas)
        self.replica_speeds = (tuple(speeds) if speeds is not None
                               else (1.0,) * self.replicas)

    def replica_seconds(self, now: float) -> float:
        return self._cap_accum + (now - self._cap_since) * self.replicas


class ServingRuntime:
    def __init__(self, stages: list[RuntimeStage], *,
                 telemetry: Telemetry | None = None, pipe: Pipeline | None = None,
                 loop: EventLoop | None = None):
        self.stages = stages
        self.telemetry = telemetry or Telemetry()
        self._loop = loop if loop is not None else EventLoop()
        self.completed: list[Request] = []
        self.in_system = 0            # arrived, not yet fully served
        self.switch_count = 0
        self.prewarm_count = 0        # off-path variant warm-ups started
        self.migration_count = 0      # replicas moved across nodes by reconfigs
        self.last_migrations = 0
        self.stale_timers_dropped = 0  # superseded timer events ignored
        # admission hook (multi-tenant load shedding): ``admission(runtime,
        # request) -> bool`` decides at arrival time; a rejected request is
        # recorded as offered + shed and never enters a queue
        self.admission = None
        # cluster topology: placement charges replica-seconds per node and
        # adjacent stages on different primary nodes pay a transfer hop
        self.pipe = pipe
        self.topo = pipe.topo if pipe is not None else None
        n_nodes = self.topo.n_nodes if self.topo is not None else 1
        self.node_busy = [0.0] * n_nodes
        self._node_repl = [0] * n_nodes
        self._node_accum = [0.0] * n_nodes
        self._node_since = 0.0
        self._primary = tuple(0 for _ in stages)
        if pipe is not None:
            self._install_placement(placement_for(pipe, self.config))

    @property
    def now(self) -> float:
        """The virtual clock — owned by the (possibly shared) event loop."""
        return self._loop.now

    # ----------------------------------------------------------- set-up --

    @classmethod
    def from_pipeline(cls, pipe: Pipeline, *, cfg: Config | None = None,
                      max_wait: float = DEFAULT_MAX_WAIT, seq_len: int = 32,
                      executors: list | None = None,
                      loop: EventLoop | None = None) -> ServingRuntime:
        """Stages mirror ``pipe``'s tasks; initial knobs from ``cfg``
        (default: cheapest variant, 1 replica, batch 1). Replicas are placed
        on ``pipe``'s cluster topology by the shared first-fit scheduler.
        ``loop`` shares an event loop with other runtimes (fleet serving)."""
        if cfg is None:
            n = pipe.n_tasks
            cfg = Config(z=(0,) * n, f=(1,) * n, b=(1,) * n)
        stages = [
            RuntimeStage(task.name, task, z=cfg.z[i], replicas=cfg.f[i],
                         batch_size=cfg.b[i], max_wait=max_wait,
                         seq_len=seq_len,
                         executor=executors[i] if executors else None)
            for i, task in enumerate(pipe.tasks)
        ]
        return cls(stages, pipe=pipe, loop=loop)

    def _install_placement(self, pl):
        """Point every stage's replica pool at its assigned nodes and roll
        the per-node replica-seconds integral forward."""
        speeds = [n.speed for n in self.topo.nodes]
        for k in range(len(self._node_repl)):
            self._node_accum[k] += ((self.now - self._node_since)
                                    * self._node_repl[k])
        self._node_since = self.now
        counts = [0] * len(self._node_repl)
        for stage, nodes in zip(self.stages, pl.nodes, strict=True):
            stage.replica_nodes = tuple(nodes)
            stage.replica_speeds = tuple(speeds[k] for k in nodes)
            for k in nodes:
                counts[k] += 1
        self._node_repl = counts
        self._primary = pl.primary

    def load(self, process, horizon: float, *, vocab: int = 256,
             seq_len: int | None = None, rid_base: int = 0) -> int:
        """Pre-register arrivals from ``process`` over [now, now+horizon)."""
        seq_len = seq_len or self.stages[0].seq_len
        times = process.generate(horizon) + self.now
        rng = np.random.default_rng(process.seed + 1)
        for i, t in enumerate(times):
            toks = rng.integers(1, vocab, size=seq_len).astype(np.int32)
            self.submit(Request(rid=rid_base + i, tokens=toks), at=float(t))
        return len(times)

    def submit(self, req: Request, *, at: float | None = None):
        t = self.now if at is None else at
        req.arrival = t
        self._push(t, "arrival", req)

    # ------------------------------------------------------ control API --

    def prewarm(self, stage: int, z: int, *,
                cold_start: float = COLD_START_SECONDS) -> bool:
        """Start warming variant ``z`` on ``stage`` *off the serving path*:
        the cold start runs in the background (container pull / weight load
        on spare node capacity) while the live variant keeps serving. A
        later ``apply_config`` switching this stage to ``z`` pays only the
        warm-up still outstanding — zero if ``cold_start`` seconds have
        already elapsed. A no-op when ``z`` is already live or already
        warming; re-warming a *different* variant replaces the previous
        warm (one standby slot per stage). Returns True iff a warm-up was
        started."""
        st = self.stages[stage]
        z = int(z) % len(st.task.variants)
        if z == st.z:
            return False
        if st.warm_z == z:
            return False  # already warming (possibly already ready)
        st.warm_z = z
        st.warm_ready = self.now + cold_start
        self.prewarm_count += 1
        return True

    def apply_config(self, cfg: Config, *,
                     cold_start: float = COLD_START_SECONDS) -> int:
        """Live reconfiguration (the OPD action). Variant switches pay
        ``cold_start`` virtual seconds of stage unavailability; queued
        requests hold (nothing is dropped). Replicas are re-placed on the
        cluster by the shared scheduler; ``last_migrations`` reports how many
        continuing replicas had to move nodes. Returns #stages switched."""
        switched = 0
        pl = None
        if self.pipe is not None:
            old_nodes = [s.replica_nodes for s in self.stages]
            pl = placement_for(self.pipe, cfg)
        for n, stage in enumerate(self.stages):
            z_new = int(cfg.z[n]) % len(stage.task.variants)
            if z_new != stage.z:
                switched += 1
                stage.z = z_new
                if stage.warm_z == z_new:
                    # pre-warmed: pay only the warm-up still outstanding
                    # (zero once warm_ready has passed)
                    stage.blocked_until = max(stage.blocked_until,
                                              stage.warm_ready)
                else:
                    stage.blocked_until = max(stage.blocked_until,
                                              self.now + cold_start)
                # any variant switch retires the standby slot: a warm for
                # the new variant is consumed, a warm for some other
                # variant is stale (the fabric re-targets the slot)
                stage.warm_z = None
            stage.set_replicas(int(cfg.f[n]), self.now)
            stage.batcher.batch_size = max(1, int(cfg.b[n]))
        if pl is not None:
            self._install_placement(pl)
            self.last_migrations = sum(
                _migrations(old, stage.replica_nodes)
                for old, stage in zip(old_nodes, self.stages, strict=True))
            self.migration_count += self.last_migrations
        self.switch_count += switched
        self.telemetry.record_reconfig(self.now, switched)
        for i, stage in enumerate(self.stages):
            # timers armed under the old configuration (old batch deadline /
            # cold-start gate, possibly retired batchers or replicas) are no
            # longer authoritative: invalidate them so the poke below arms a
            # fresh one for the *new* configuration and the heaped ones are
            # dropped as stale when they fire
            stage._pending_timer = None
            self._poke(i)
        return switched

    @property
    def config(self) -> Config:
        return Config(z=tuple(s.z for s in self.stages),
                      f=tuple(s.replicas for s in self.stages),
                      b=tuple(s.batcher.batch_size for s in self.stages))

    # -------------------------------------------------------- event loop --

    def _push(self, t: float, kind: str, payload):
        self._loop.push(t, self, kind, payload)

    def run_until(self, t_end: float):
        """Process all events with time <= t_end; clock lands on t_end.
        On a shared loop this advances *every* runtime on it — the fleet's
        tenants march through one interleaved virtual timeline."""
        self._loop.run_until(t_end)

    def drain(self):
        """Run the loop dry — every admitted request completes."""
        self._loop.drain()

    # ---------------------------------------------------------- handlers --

    def _handle(self, kind: str, payload):
        """Event dispatch — called by the (possibly shared) event loop."""
        if kind == "arrival":
            self._on_arrival(payload)
        elif kind == "complete":
            self._on_complete(*payload)
        elif kind == "timer":
            self._on_timer(*payload)
        elif kind == "xfer":
            self._on_xfer(*payload)

    def _on_arrival(self, req: Request):
        self.telemetry.record_arrival(self.now)
        if self.admission is not None and not self.admission(self, req):
            # shed: counted as offered load, never queued, never completes
            self.telemetry.record_shed(self.now)
            return
        self.in_system += 1
        self.stages[0].batcher.put(req, self.now)
        self._poke(0)

    def _on_timer(self, i: int, armed_at: float):
        """A timer is only actionable if it is still the stage's pending one.
        Reconfigurations (and re-arms at a different deadline) supersede
        previously heaped timers — those must be ignored, not fired against
        the new configuration."""
        stage = self.stages[i]
        if (stage._pending_timer is None
                or abs(stage._pending_timer - armed_at) > 1e-12):
            self.stale_timers_dropped += 1
            return
        stage._pending_timer = None
        self._poke(i)

    def _on_complete(self, i: int, reqs: list[Request], z: int,
                     replica: int = 0):
        stage = self.stages[i]
        stage.in_flight -= 1
        stage.release_replica(replica)
        stage.served += len(reqs)
        if stage.executor is not None:
            with tracing.span("runtime.batch", stage=i, variant=z, rows=len(reqs)) as sp:
                if sp.on:
                    sp.attrs["rids"] = [req.rid for req in reqs]
                out = np.asarray(stage.executor(
                    z, stack_tokens(reqs, stage.seq_len)))
                for k, req in enumerate(reqs):
                    req.stage_outputs.append(out[k])
                    req.result = out[k]
        else:
            for req in reqs:
                req.stage_outputs.append(req.tokens)
                req.result = req.tokens
        if i + 1 < len(self.stages):
            for req in reqs:
                # next stage consumes this stage's output tokens
                req.tokens = np.asarray(req.result, dtype=np.int32).reshape(-1)
            hop = self.topo.hop_latency if self.topo is not None else 0.0
            if hop > 0.0 and self._primary[i] != self._primary[i + 1]:
                # cross-node transfer: the batch reaches the next stage's
                # queue only after the network hop
                self._push(self.now + hop, "xfer", (i + 1, reqs))
            else:
                self._on_xfer(i + 1, reqs)
        else:
            for req in reqs:
                req.finish = self.now
                self.telemetry.record_completion(req.rid, req.arrival, self.now)
                self.completed.append(req)
            self.in_system -= len(reqs)
        self._poke(i)

    def _on_xfer(self, i: int, reqs: list[Request]):
        nxt = self.stages[i]
        for req in reqs:
            nxt.batcher.put(req, self.now)
        self._poke(i)

    def _poke(self, i: int):
        """Dispatch every batch the stage can take now; otherwise arm a timer
        for the next timeout-or-unblock instant."""
        stage = self.stages[i]
        while (stage.in_flight < stage.replicas
               and self.now >= stage.blocked_until - 1e-12
               and stage.batcher.ready(self.now)):
            reqs = stage.batcher.pop(self.now)
            replica = stage.claim_replica()
            service = stage.service_time(len(reqs),
                                         stage.replica_speeds[replica])
            stage.in_flight += 1
            stage.busy_time += service
            node = stage.replica_nodes[replica]
            if node < len(self.node_busy):
                self.node_busy[node] += service
            self.telemetry.record_batch(i, self.now, len(reqs), service,
                                        len(stage.batcher))
            # pin the dispatch-time variant and replica: a mid-flight switch
            # must not change which model serves an already-running batch
            self._push(self.now + service, "complete",
                       (i, reqs, stage.z, replica))
        if len(stage.batcher) and stage.in_flight < stage.replicas:
            t_need = max(stage.batcher.deadline(), stage.blocked_until)
            live = (stage._pending_timer is not None
                    and self.now - 1e-12 <= stage._pending_timer <= t_need + 1e-12)
            if t_need > self.now and not live:
                self._push(t_need, "timer", (i, t_need))
                stage._pending_timer = t_need

    # ----------------------------------------------------------- queries --

    def queue_depths(self) -> list[int]:
        return [len(s.batcher) for s in self.stages]

    def utilization(self) -> list[float]:
        return [s.busy_time / max(s.replica_seconds(self.now), 1e-9)
                for s in self.stages]

    def node_replica_seconds(self) -> list[float]:
        return [acc + (self.now - self._node_since) * n
                for acc, n in zip(self._node_accum, self._node_repl,
                                  strict=True)]

    def node_utilization(self) -> list[float]:
        """Per-node busy replica-seconds over available replica-seconds."""
        return [busy / max(cap, 1e-9)
                for busy, cap in zip(self.node_busy,
                                     self.node_replica_seconds(),
                                     strict=True)]

    def summary(self) -> dict:
        out = self.telemetry.summary(
            self.now,
            stage_busy=[s.busy_time for s in self.stages],
            stage_capacity=[s.replica_seconds(self.now)
                            for s in self.stages])
        out["migrations"] = self.migration_count
        out["prewarms"] = self.prewarm_count
        if self.topo is not None and self.topo.n_nodes > 1:
            out["node_busy_s"] = list(self.node_busy)
            out["node_utilization"] = self.node_utilization()
        return out


def _migrations(old: tuple[int, ...], new: tuple[int, ...]) -> int:
    """Continuing replicas of a stage that had to move nodes: the overlap
    shortfall between the old and new node multisets."""
    overlap = 0
    nodes = set(old) | set(new)
    for k in nodes:
        overlap += min(old.count(k), new.count(k))
    return max(0, min(len(old), len(new)) - overlap)
