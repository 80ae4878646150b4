"""Fig. 6 — decision time vs pipeline complexity (the counterpart of the
reference's ``benchmarks/fig6_decision_time.py``: same pipelines, step
counts, rows and payload keys). IPA's solver enumerates the configuration
space on the host (grows with stages x variants); OPD's policy forward pass
is O(|N|) and runs on ``device``, its d_t clock stopping once the action is
on the host. Paper: OPD faster by 32.5 / 53.5 / 111.6 / 212.8 % over one
workload cycle across 4 increasingly complex pipelines.

    PYTHONPATH=src python -m repro_torch.launch.fig6_decision_time [--quick] [--device cpu]

``run``'s ``steps`` and ``pipelines`` default to the reference's.
"""
from __future__ import annotations

from repro_torch.api import PipelineSpec
from repro_torch.cluster import PipelineEnv, make_trace
from repro_torch.core import IPAPolicy, OPDPolicy, OPDTrainer, PPOConfig, run_episode
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results

# four pipeline specs of growing decision-space size (stages x variants/stage)
PIPELINES = [
    PipelineSpec("P1-2stage", (("xlstm-125m", "whisper-small"),) * 2, quants=("bf16",)),
    PipelineSpec(
        "P2-3stage",
        (("xlstm-125m", "whisper-small", "llama3.2-1b"),) * 3,
        quants=("bf16", "int8"),
    ),
    PipelineSpec(
        "P3-4stage",
        (("xlstm-125m", "llama3.2-1b", "starcoder2-3b"),) * 4,
        quants=("bf16", "int8", "int4"),
    ),
    PipelineSpec(
        "P4-5stage",
        (("xlstm-125m", "llama3.2-1b", "starcoder2-3b"),) * 5,
        quants=("bf16", "int8", "int4"),
    ),
]


def decision_space(pipe) -> int:
    """Configurations (variant x replicas x batch per stage) of ``pipe``."""
    n_configs = 1
    for t in pipe.tasks:
        n_configs *= len(t.variants) * pipe.f_max * pipe.b_max
    return n_configs


def run(quick: bool = False, *, device="cuda", steps: int | None = None,
        pipelines=None):
    dev = resolve_device(device)
    rows, payload = [], {}
    # decision TIME per step is workload-independent; 10-20 decisions give a
    # stable mean while keeping IPA's 9^5-combo enumeration affordable
    steps = steps or (10 if quick else 20)
    pipelines = pipelines or PIPELINES
    for spec in pipelines:
        name, pipe = spec.name, spec.build()

        def make_env(seed, pipe=pipe):
            tr = make_trace("fluctuating", seed=seed, seconds=steps * 10)
            return PipelineEnv(pipe, tr, seed=seed)

        # a briefly-trained policy: decision TIME does not depend on training
        tr_ = OPDTrainer(pipe, make_env, ppo=PPOConfig(epochs=1), seed=0, device=dev)
        tr_.train_episode(1)
        env = make_env(5)
        ipa = IPAPolicy(pipe)
        opd = OPDPolicy(pipe, tr_.params, device=dev)
        res_ipa = run_episode(env, ipa)
        res_opd = run_episode(make_env(5), opd)
        h_ipa = res_ipa["decision_time_total"]
        h_opd = res_opd["decision_time_total"]
        speedup_pct = 100.0 * (h_ipa - h_opd) / h_opd
        payload[name] = {
            "ipa_H_s": h_ipa,
            "opd_H_s": h_opd,
            "opd_faster_pct": speedup_pct,
            "decision_space": decision_space(pipe),
        }
        rows.append(("fig6", f"{name}.opd_faster_pct", round(speedup_pct, 1),
                     "paper: 32.5/53.5/111.6/212.8% growing with complexity"))
    # the headline property: IPA time grows with complexity, OPD stays flat
    ipas = [payload[s.name]["ipa_H_s"] for s in pipelines]
    opds = [payload[s.name]["opd_H_s"] for s in pipelines]
    rows.append(("fig6", "ipa_H_growth_x", round(ipas[-1] / ipas[0], 2),
                 "grows with pipeline complexity"))
    rows.append(("fig6", "opd_H_growth_x", round(opds[-1] / opds[0], 2), "stays ~flat"))
    save_results("fig6_decision_time", payload, device=device)
    return rows


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
