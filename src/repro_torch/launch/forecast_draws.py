"""How far fig45's proactive arm depends on its forecaster's training draw.

Serves the ``proactive_capacity`` arm of ``launch/fig45_workloads.py`` (the
same pipeline, ``PROACTIVE_RATE`` and ``EVAL_SEED``) with ``lstm-multi``
forecasters that differ only in their initial-weight seed. Each seed is
served three times:

- ``cpu``: the forecaster trained and forecasting on the CPU;
- ``device``: trained and forecasting on ``device``, as fig45 runs on a card;
- ``carried``: the CPU-trained weights forecasting on ``device``.

``carried`` equal to ``cpu`` says that the device's forward pass takes the
CPU's decisions. The spread of ``cpu`` and ``device`` across seeds is the
spread of the draw.

    PYTHONPATH=src python -m repro_torch.launch.forecast_draws \
        [--regime bursty] [--horizon 160] [--seeds 0 1 2 3 4] [--device cpu] [--out DIR]

It prints one line per seed and writes
``<out>/forecast_draws_<regime>_<horizon>.json``.
"""
from __future__ import annotations

import contextlib
import copy

from repro_torch import api
from repro_torch.core import forecast
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results
from repro_torch.launch.fig45_workloads import _serving_episode


@contextlib.contextmanager
def _trainer(fn):
    """Route ``Session.build_forecaster``'s training through ``fn``."""
    train = forecast.train_forecaster
    forecast.train_forecaster = fn
    try:
        yield
    finally:
        forecast.train_forecaster = train


def run(regime: str = "bursty", horizon: int = 160, seeds=(0, 1, 2, 3, 4), *,
        predictor: str = "lstm-multi", device="cuda") -> dict:
    dev = resolve_device(device)
    train = forecast.train_forecaster
    pipeline, base = api.get_pipeline("paper-4stage"), api.get_predictor(predictor)

    def serve(name, on):
        return _serving_episode(regime, "proactive-capacity", None, pipeline,
                                horizon=horizon, predictor=name, device=on)

    payload = {"regime": regime, "horizon": horizon, "predictor": predictor, "seeds": {}}
    for seed in seeds:
        name = f"{predictor}-seed{seed}"
        api.register_predictor(api.replace(base, name=name, seed=seed))
        fit = []

        def keep(traces, **kw):
            fit.append(train(traces, **kw))
            return fit[-1]

        with _trainer(keep):
            cpu = serve(name, "cpu")
        (params, scales), = fit
        with _trainer(lambda traces, **kw: (copy.deepcopy(params).to(dev), scales)):
            carried = serve(name, dev)
        res = {"cpu": cpu, "device": serve(name, dev), "carried": carried}
        payload["seeds"][str(seed)] = res
        print(f"forecast_draws: {regime} {horizon} s seed {seed}: " + "; ".join(
            f"{k} p99 {v['p99']:.4f} s, cost {v['cost']:.4f}, prewarms {v['prewarms']}"
            for k, v in res.items()), flush=True)
    save_results(f"forecast_draws_{regime}_{horizon}", payload, device=device)
    return payload


if __name__ == "__main__":
    import argparse

    from repro_torch.launch.bench import set_results_dir
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--regime", default="bursty")
    ap.add_argument("--horizon", type=int, default=160)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, metavar="DIR")
    args = ap.parse_args()
    set_results_dir(args.out)
    run(args.regime, args.horizon, tuple(args.seeds), device=args.device)
