"""Compare Random / Greedy / IPA / OPD on one workload cycle (paper Fig. 4-5
in miniature) on the PyTorch port, built entirely from ``repro_torch.api``
specs (the twin of ``examples/compare_baselines.py``: the same flags and
printed lines, plus ``--device``).

    PYTHONPATH=src python examples/compare_baselines_torch.py \
        [--workload fluctuating] [--device cpu]

Random, Greedy and IPA are host NumPy and print the reference's lines; OPD
trains and decides on ``--device`` (default cuda).
"""
import argparse

from repro_torch import api

ap = argparse.ArgumentParser()
ap.add_argument("--workload", default="fluctuating",
                choices=["steady_low", "fluctuating", "steady_high"])
ap.add_argument("--episodes", type=int, default=8)
ap.add_argument("--device", default="cuda",
                help="torch device OPD trains and decides on (default cuda)")
args = ap.parse_args()

scenario = api.replace(api.get_scenario(args.workload), seed=42)

print(f"\n{args.workload}: {scenario.horizon} s cycle, 10 s adaptation interval")
print(f"{'policy':8s} {'cost(chips)':>12s} {'QoS':>9s} {'latency(s)':>11s} "
      f"{'decision H(s)':>14s}")
for name in ("random", "greedy", "ipa", "opd"):
    controller = api.replace(api.get_controller(name), seed=7,
                             train_episodes=args.episodes, expert_freq=3)
    exp = api.ExperimentSpec(pipeline=api.get_pipeline("paper-4stage"),
                             scenario=scenario, controller=controller,
                             backend="analytic")
    res = api.run_experiment(exp, device=args.device)
    cost = sum(res["cost"]) / len(res["cost"])
    qos = sum(res["qos"]) / len(res["qos"])
    lat = sum(res["latency"]) / len(res["latency"])
    h = res.get("decision_time_total", float("nan"))
    print(f"{name:8s} {cost:12.2f} {qos:9.2f} {lat:11.3f} {h:14.3f}")
