"""Quickstart on the PyTorch port — the paper's pipeline + OPD agent through
the declarative control-plane API of ``repro_torch`` (the twin of
``examples/quickstart.py``: the same flags and printed lines, plus
``--device``).

    PYTHONPATH=src python examples/quickstart_torch.py [--episodes 8] [--device cpu]

Builds the registered 4-stage edge pipeline, trains the OPD agent for a
handful of PPO episodes with expert guidance on ``--device`` (default
cuda), then evaluates it against the Greedy baseline on a fluctuating
workload cycle. The whole experiment is an ``ExperimentSpec``: serialize it
with ``json.dumps(exp.to_dict())`` and any machine reproduces this run on
the same kind of device.
"""
import argparse

import numpy as np

from repro_torch import api

ap = argparse.ArgumentParser()
ap.add_argument("--episodes", type=int, default=8)
ap.add_argument("--device", default="cuda",
                help="torch device OPD trains and decides on (default cuda)")
args = ap.parse_args()

pipe_spec = api.get_pipeline("paper-4stage")
pipe = pipe_spec.build()
print(f"pipeline: {pipe.name}, {len(pipe.tasks)} stages, "
      f"{sum(len(t.variants) for t in pipe.tasks)} model variants total")

scenario = api.replace(api.get_scenario("fluctuating"), seed=99)
for name in ("greedy", "opd"):
    exp = api.ExperimentSpec(
        pipeline=pipe_spec, scenario=scenario, backend="analytic",
        controller=api.replace(api.get_controller(name),
                               train_episodes=args.episodes, expert_freq=3))
    res = api.run_experiment(exp, log=print, device=args.device)
    excess = np.clip(res["excess"], 0, None)
    print(f"{name:6s}: mean cost={np.mean(res['cost']):7.2f} chips  "
          f"mean QoS={np.mean(res['qos']):7.2f}  "
          f"unmet demand={excess.mean():6.3f} req/s")
