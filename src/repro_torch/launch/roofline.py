"""Roofline collector of the card (the counterpart of the reference's
``benchmarks/roofline.py``): reads the dry-run records that
``launch/dryrun.py`` writes (``<dir>/*_1x1.json``, default
``chiprun_out/dryrun``) and emits the per-(arch x shape) roofline table of
one H100: two terms in seconds, the dominant one, the model-flops /
counted-flops usefulness ratio, and, where the record was run on the card,
its measured ms and share of the bound.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dryrun-dir DIR] \
        [--device cpu] [--out DIR]

Where the records differ from the reference's:
  * the mesh is ``"1x1"`` (one card), and the output is ``roofline_1x1``;
  * the peak is the record's top-level ``peak_bytes``;
  * ``roofline.collective_s`` is ``None`` (no collective on one card): a
    row's bound is the record's ``bound_s``, and ``collective_s`` stays
    ``None`` in the row;
  * ``measured_ms`` and ``share_of_bound`` come from a record's
    ``measured`` block where it has one (else ``None``);
  * a DOES_NOT_FIT record gives its counted peak against the card's bytes
    as its reason.

``--quick`` changes nothing: the records are read, not made.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results

MESH = "1x1"
DRYRUN_DIR = os.path.join("chiprun_out", "dryrun")


def load_records(dryrun_dir: str = DRYRUN_DIR, mesh: str | None = MESH) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if mesh is None or r.get("mesh") == mesh:
            recs.append(r)
    return recs


def _reason(r: dict) -> str:
    if r["status"] == "DOES_NOT_FIT":
        return (f"peak {r['peak_bytes'] / 1e9:.1f} GB > "
                f"{r['hbm_bytes'] / 1e9:.0f} GB")
    return r.get("reason", r.get("error", ""))


def table(mesh: str = MESH, dryrun_dir: str = DRYRUN_DIR) -> list[dict]:
    """-> list of row dicts: the OK records sorted worst-first by their
    bound, then the others (DOES_NOT_FIT, SKIP) with their reason."""
    rows = []
    for r in load_records(dryrun_dir, mesh):
        head = {"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                "status": r["status"]}
        if r["status"] != "OK":
            rows.append({**head, "reason": _reason(r)})
            continue
        t, m = r["roofline"], r.get("measured") or {}
        rows.append({
            **head,
            "compute_s": t["compute_s"],
            "memory_s": t["memory_s"],
            "collective_s": t["collective_s"],
            "dominant": t["dominant"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "peak_gb_per_dev": r["peak_bytes"] / 1e9,
            "step_time_bound_s": t["bound_s"],
            "roofline_fraction": t["compute_s"] / max(t["bound_s"], 1e-30),
            "measured_ms": m.get("ms"),
            "share_of_bound": m.get("share_of_bound"),
        })
    ok = [x for x in rows if x["status"] == "OK"]
    ok.sort(key=lambda x: -x["step_time_bound_s"])
    return ok + [x for x in rows if x["status"] != "OK"]


def run(quick: bool = False, *, device="cuda", dryrun_dir: str = DRYRUN_DIR):
    resolve_device(device)
    tab = table(MESH, dryrun_dir)
    oks = [x for x in tab if x["status"] == "OK"]
    if not oks:
        return [("roofline", "records", 0, "run launch/dryrun first")]
    save_results(f"roofline_{MESH}", {"rows": tab}, device=device)
    by_dom = {}
    for x in oks:
        by_dom[x["dominant"]] = by_dom.get(x["dominant"], 0) + 1
    worst = oks[0]
    best_frac = max(oks, key=lambda x: x["roofline_fraction"])
    rows = [
        ("roofline", "records_ok", len(oks), f"of {len(tab)} records"),
        ("roofline", "dominant_split",
         "/".join(f"{k}:{v}" for k, v in sorted(by_dom.items())), ""),
        ("roofline", "slowest_pair", f"{worst['arch']}|{worst['shape']}",
         f"bound {worst['step_time_bound_s']:.3f}s dom={worst['dominant']}"),
        ("roofline", "best_compute_fraction",
         f"{best_frac['arch']}|{best_frac['shape']}={best_frac['roofline_fraction']:.2f}", ""),
    ]
    rows += [("roofline", f"{x['arch']}|{x['shape']}.share_of_bound",
              round(x["share_of_bound"], 4), f"measured {x['measured_ms']:.4f} ms")
             for x in oks if x["share_of_bound"] is not None
             and not isinstance(x["share_of_bound"], str)]
    return rows


def markdown(mesh: str = MESH, baseline_dir: str | None = None,
             dryrun_dir: str = DRYRUN_DIR) -> str:
    """The roofline table as markdown, with ratios against the records in
    ``baseline_dir`` where a term moved by more than 5%."""
    rows = table(mesh, dryrun_dir)
    base = ({(x["arch"], x["shape"]): x for x in table(mesh, baseline_dir)
             if x["status"] == "OK"} if baseline_dir else {})
    out = ["| arch | shape | compute s | memory s | dominant | useful | peak GB/dev "
           "| measured ms | share of bound |",
           "|---|---|---|---|---|---|---|---|---|"]
    for x in rows:
        if x["status"] != "OK":
            out.append(f"| {x['arch']} | {x['shape']} | — | — | "
                       f"{x['status']}: {x['reason']} | — | — | — | — |")
            continue

        def fmt(key, nd=4, x=x):
            v = x[key]
            b = base.get((x["arch"], x["shape"]))
            if b and b[key] > 0 and abs(v / b[key] - 1) > 0.05:
                return f"{v:.{nd}g} ({v / b[key]:.2g}x)"
            return f"{v:.{nd}g}"

        measured = ("—" if x["measured_ms"] is None else f"{x['measured_ms']:.4f}")
        share = x["share_of_bound"]
        share = ("—" if share is None else share if isinstance(share, str)
                 else f"{share:.4f}")
        out.append(f"| {x['arch']} | {x['shape']} | {fmt('compute_s')} | "
                   f"{fmt('memory_s')} | {x['dominant'].replace('_s', '')} | "
                   f"{x['useful_flops_ratio']:.2f} | {x['peak_gb_per_dev']:.1f} | "
                   f"{measured} | {share} |")
    return "\n".join(out)


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=DRYRUN_DIR,
                    help=f"the dry run's records (default {DRYRUN_DIR})")
    bench_main(run, parser=ap, kwargs_from_args=lambda a: {"dryrun_dir": a.dryrun_dir})
