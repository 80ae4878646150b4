"""Closed-loop serving demo on the PyTorch port (the twin of
``examples/serve_pipeline.py``: the same flags and printed lines, plus
``--device``): the event-driven runtime serves a bursty arrival trace
through a multi-stage pipeline while the OPD agent reconfigures the live
system (variant switch / replicas / batch size) every adaptation interval.

    PYTHONPATH=src python examples/serve_pipeline_torch.py \
        [--horizon 120] [--train-episodes 4] [--scenario bursty] [--real] [--device cpu]

Everything is declared through ``repro_torch.api``: the registered "serve3"
pipeline, an arrival ScenarioSpec, and an OPD ControllerSpec. The Session
trains the agent on ``--device`` (default cuda) on the analytic simulator
(PipelineEnv) over the scenario's own rate profile, then controls the real
thing: RuntimeEnv steps the virtual-time event loop one 10 s interval per
decision. ``--real`` additionally attaches live PyTorch models as stage
executors, so request tokens flow through live forward passes, with
attention through the hand-written Hopper kernels on a CUDA device. Unlike
the reference's smoke-scale JAX executors, they run serve3's archs at full
width in float32 (about 43 GiB of weights): ``--real`` needs the card's
memory.
"""
import argparse
import time

import numpy as np

from repro_torch import api

ap = argparse.ArgumentParser()
ap.add_argument("--horizon", type=int, default=120,
                help="virtual seconds of traffic to serve")
ap.add_argument("--train-episodes", type=int, default=4)
ap.add_argument("--scenario", default="bursty", choices=api.list_scenarios())
ap.add_argument("--seq-len", type=int, default=32)
ap.add_argument("--real", action="store_true",
                help="attach live full-width PyTorch models as stage executors")
ap.add_argument("--device", default="cuda",
                help="torch device OPD and the live stages run on (default cuda)")
args = ap.parse_args()

exp = api.ExperimentSpec(
    pipeline=api.get_pipeline("serve3"),
    scenario=api.replace(api.get_scenario(args.scenario), rate=25.0, seed=7,
                         horizon=args.horizon),
    controller=api.replace(api.get_controller("opd"),
                           train_episodes=args.train_episodes, expert_freq=2),
    real=args.real, seq_len=args.seq_len)
sess = api.Session.from_spec(exp, device=args.device)

# --- control plane: OPD agent trained on the matching analytic simulator ---
t0 = time.time()
sess.train()
print(f"trained OPD agent for {args.train_episodes} episodes "
      f"in {time.time() - t0:.1f}s")

# --- data plane: the event-driven runtime -----------------------------------
agent = sess.controller = sess.build_controller()


def show(env, cfg, info):
    print(f"[t={env.runtime.now:5.0f}s] z={cfg.z} f={cfg.f} b={cfg.b} "
          f"demand={info['demand']:5.1f}/s served={info['processed']:4d} "
          f"p50={info['p50'] * 1e3:6.1f}ms p95={info['p95'] * 1e3:6.1f}ms "
          f"p99={info['p99'] * 1e3:6.1f}ms backlog={info['backlog']:4d} "
          f"cost={info['cost']:4.0f} "
          f"decision={agent.decision_times[-1] * 1e3:5.1f}ms"
          + (" [switch]" if info["switched"] else ""))


wall0 = time.time()
report = sess.serve(on_step=show)
wall = time.time() - wall0

summary = report["summary"]
submitted = summary["submitted"]


def ms(v):
    # summary latency fields are None (not NaN) when nothing completed
    return "n/a" if v is None else f"{v * 1e3:.1f}ms"


print(f"\nserved {summary['served']}/{submitted} requests "
      f"({summary['throughput_rps']:.1f} req/s virtual, "
      f"{summary['served'] / max(wall, 1e-9):.0f} req/s wall)")
print(f"latency p50={ms(summary['p50'])} "
      f"p95={ms(summary['p95'])} p99={ms(summary['p99'])} "
      f"mean={ms(summary['latency_mean_s'])}")
print(f"mean cost={np.mean(report['cost']):.1f} chips, "
      f"{summary['switches']} live variant switches, "
      f"mean batch={summary['mean_batch_size']:.1f}, "
      f"decision H={report['decision_time_total']:.3f}s over "
      f"{len(report['decision_times'])} decisions")
print("stage utilization: "
      + " ".join(f"{u:.2f}" for u in summary["utilization"]))
if summary["served"] != submitted:
    raise SystemExit(f"every request must complete: served {summary['served']}/{submitted}")
