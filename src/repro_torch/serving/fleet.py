"""Multi-tenant fleet serving: N pipelines on one shared cluster.

A :class:`FleetRuntime` hosts N tenants — each a full closed-loop
``cluster.env.RuntimeEnv`` (pipeline + arrival process + telemetry) driven by
its own per-pipeline controller — on ONE shared :class:`EventLoop` and one
``ClusterTopology``. Three mechanisms knit them into a fleet:

- **Shared virtual timeline.** Every tenant's arrivals, batch dispatches and
  completions interleave on the same event heap, FIFO tie-broken by a global
  insertion sequence, so a fleet run is exactly as deterministic as a
  single-pipeline run. A fleet of one tenant *is* the historical
  single-pipeline runtime, event for event.

- **Priority-graded admission control.** Under overload (fleet-wide backlog
  against ``admission_limit``) the lowest priority class sheds first: a
  tenant at priority rank k of K admits only while the fleet backlog is
  below ``admission_limit * (k+1)/K``, so the highest class keeps admitting
  until the full limit. Shed requests are counted as offered load and
  reported as a per-tenant shed rate — they never enter a queue.

- **Fleet-level arbitration.** Before each adaptation interval the fleet
  re-divides the cluster between tenants proportionally to
  ``priority x predicted load`` (floored at ``min_share``): each tenant's
  controller then optimizes (variant, replicas, batch) against a
  capacity-scaled *view* of the cluster — the existing per-pipeline
  OPD/baseline controllers run unmodified within their allocation.

The interval protocol is two-phase: every tenant's action is applied
(``begin_step``) before the shared loop advances (one ``run_until``), then
every tenant scores its interval (``finish_step``) — so no tenant sees
another's reconfiguration land mid-interval.

Port of ``repro/serving/fleet.py``: NumPy and plain Python on the port's
``RuntimeEnv(loop=, rid_base=)``, so a fleet run matches the reference's
event for event. Like the reference's, the fleet attaches no live stage
executors.
"""
from __future__ import annotations

import math
from dataclasses import replace

from repro_torch.cluster.topology import ClusterTopology
from repro_torch.core.controller import decide
from repro_torch.core.mdp import ADAPTATION_INTERVAL
from repro_torch.serving.runtime import EventLoop

# Tenant shares are floor-quantized to this resolution before topologies are
# rebuilt: coarse shares keep the placement lru_cache from churning a fresh
# topology object every interval, and flooring keeps the sum <= 1.
SHARE_QUANTUM = 1e-4


def scale_topology(topo: ClusterTopology, share: float) -> ClusterTopology:
    """A tenant's view of the cluster: every node's capacity scaled by its
    fleet share. ``share >= 1.0`` returns ``topo`` itself (identity — the
    degenerate single-tenant fleet keeps the exact topology object, so
    placements and telemetry reproduce the standalone runtime bit-for-bit).
    """
    if share >= 1.0:
        return topo
    nodes = tuple(replace(n, capacity=n.capacity * share)
                  for n in topo.nodes)
    return ClusterTopology(name=f"{topo.name}@{share:.4f}", nodes=nodes,
                           hop_latency=topo.hop_latency)


class FleetTenant:
    """One tenant: a closed-loop env + its controller + fleet metadata.

    ``set_share`` rebinds the tenant's pipeline to a capacity-scaled view of
    the cluster — env, live runtime and controller all see the same scaled
    ``Pipeline`` (controllers keep a ``pipe`` attribute for their budget
    loops, so it must be rebound too)."""

    def __init__(self, name: str, env, controller, *, priority: int = 1,
                 slo_p99: float | None = None):
        self.name = name
        self.env = env
        self.controller = controller
        self.priority = int(priority)
        self.slo_p99 = slo_p99
        self.share = 1.0
        self._base_pipe = env.pipe          # full-cluster pipeline

    def set_share(self, share: float) -> bool:
        """Install a new cluster share; returns True when it changed."""
        if share == self.share:
            return False
        self.share = share
        base = self._base_pipe
        pipe = replace(base, w_max=base.w_max * share,
                       topology=scale_topology(base.topo, share))
        self.env.pipe = pipe
        self.env.runtime.pipe = pipe
        self.env.runtime.topo = pipe.topo
        if hasattr(self.controller, "pipe"):
            self.controller.pipe = pipe
        return True


class FleetRuntime:
    """N tenants sharing one event loop and one cluster topology."""

    def __init__(self, tenants: list[FleetTenant], *, loop: EventLoop,
                 admission_limit: float | None = None,
                 min_share: float = 0.08):
        self.tenants = list(tenants)
        self.loop = loop
        self.admission_limit = admission_limit
        self.min_share = float(min_share)
        self.reallocations = 0
        # admission fraction per tenant: rank of its priority among the
        # distinct priorities, scaled to (0, 1] — under a growing fleet
        # backlog the lowest class crosses its threshold (and sheds) first
        ranks = sorted({t.priority for t in self.tenants})
        self._frac = {t.name: (ranks.index(t.priority) + 1) / len(ranks)
                      for t in self.tenants}
        if admission_limit is not None:
            for t in self.tenants:
                t.env.runtime.admission = self._admission_for(t)

    # ------------------------------------------------- admission control --

    def backlog(self) -> int:
        """Fleet-wide in-system requests (arrived, not yet fully served)."""
        return sum(t.env.runtime.in_system for t in self.tenants)

    def _admission_for(self, tenant: FleetTenant):
        limit = float(self.admission_limit) * self._frac[tenant.name]

        def admit(_runtime, _req, limit=limit):
            return self.backlog() < limit

        return admit

    # -------------------------------------------------------- arbitration --

    def reallocate(self) -> int:
        """Re-divide the cluster: share proportional to priority x predicted
        load, floored at ``min_share``, floor-quantized. Returns the number
        of tenants whose share changed (0 for a single-tenant fleet after
        the first call — its share is always exactly 1.0).

        Demand is the load predicted over the *next adaptation interval* —
        horizon-matched through ``predicted_load_at`` when the tenant env
        carries a multi-horizon forecaster, which falls back to the
        single-horizon predictor / last-second load otherwise (shares are
        re-divided once per interval, so a last-second estimate lags a
        burst by a full interval)."""
        raw = [t.priority
               * max(float(t.env.predicted_load_at(ADAPTATION_INTERVAL)), 1.0)
               for t in self.tenants]
        total = sum(raw)
        shares = [max(r / total, self.min_share) for r in raw]
        total = sum(shares)
        shares = [math.floor(s / total / SHARE_QUANTUM) * SHARE_QUANTUM
                  for s in shares]
        changed = sum(t.set_share(s)
                      for t, s in zip(self.tenants, shares, strict=True))
        if changed:
            self.reallocations += 1
        return changed

    # ------------------------------------------------------ interval loop --

    def step_interval(self) -> dict:
        """One adaptation interval for the whole fleet: arbitrate shares,
        let every controller decide and apply (phase 1), advance the shared
        loop once (phase 2), then score every tenant (phase 3)."""
        self.reallocate()
        pendings = []
        for t in self.tenants:
            action = decide(t.controller, t.env)
            pendings.append(t.env.begin_step(action))
        self.loop.run_until(max(p[1] for p in pendings))
        out = {}
        for t, pending in zip(self.tenants, pendings, strict=True):
            _obs, r, done, info = t.env.finish_step(pending)
            out[t.name] = {"reward": float(r), "done": bool(done), **info}
        return out

    def drain(self):
        """Run the shared loop dry — every admitted request completes."""
        self.loop.drain()

    # ----------------------------------------------------------- queries --

    def summary(self) -> dict:
        """Per-tenant runtime summaries plus fleet-level totals."""
        tenants = {}
        offered = served = shed = 0
        for t in self.tenants:
            s = t.env.runtime.summary()
            s["priority"] = t.priority
            s["share"] = t.share
            if t.slo_p99 is not None:
                s["slo_p99"] = t.slo_p99
                s["slo_p99_met"] = (s["p99"] is not None
                                    and s["p99"] <= t.slo_p99)
            tenants[t.name] = s
            offered += s["arrived"]
            served += s["served"]
            shed += s["shed"]
        return {
            "fleet": {
                "tenants": len(self.tenants),
                "virtual_time_s": self.loop.now,
                "events": self.loop.events,
                "offered": offered,
                "served": served,
                "shed": shed,
                "shed_rate": shed / max(offered, 1),
                "reallocations": self.reallocations,
            },
            "tenants": tenants,
        }


def build_fleet(entries: list[dict], *, admission_limit: float | None = None,
                min_share: float = 0.08, horizon: int = 120,
                max_wait: float | None = None, seq_len: int = 32,
                weights=None, history: int = 120) -> FleetRuntime:
    """Assemble a fleet from tenant descriptions. Each entry is a dict with
    ``name``, ``pipe`` (carrying the *shared* cluster topology), ``arrivals``
    and ``controller``, plus optional ``priority``, ``slo_p99``,
    ``predictor`` and ``forecaster`` (multi-horizon; drives horizon-matched
    arbitration in ``reallocate``). Request ids are offset per tenant so
    completion records stay globally unique."""
    from repro_torch.cluster.env import RuntimeEnv
    loop = EventLoop()
    tenants = []
    for i, e in enumerate(entries):
        env = RuntimeEnv(e["pipe"], e["arrivals"], horizon=horizon,
                         weights=weights, history=history,
                         predictor=e.get("predictor"),
                         forecaster=e.get("forecaster"),
                         max_wait=max_wait, seq_len=seq_len,
                         loop=loop, rid_base=i * 10_000_000)
        tenants.append(FleetTenant(e["name"], env, e["controller"],
                                   priority=e.get("priority", 1),
                                   slo_p99=e.get("slo_p99")))
    return FleetRuntime(tenants, loop=loop, admission_limit=admission_limit,
                        min_share=min_share)
