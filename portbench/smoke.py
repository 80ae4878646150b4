"""A cell cut to CPU size for the tests: the same harness, files and checks,
with every architecture reduced as the port's ``ArchConfig.smoke`` reduces it
(2 layers, width 256, 4 heads, 512 tokens of vocabulary, 16 encoder frames,
8 patches, 4 experts of which 2 a token) and the traffic cut to a few
requests of 16 tokens."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import spec


def reduce_arch(a: dict) -> dict:
    a = dict(a)
    heads = 4
    a.update(n_layers=2, d_model=min(a["d_model"], 256), n_heads=heads,
             n_kv=min(a["n_kv"], heads), d_ff=min(a["d_ff"], 512) if a["d_ff"] else 0,
             vocab=min(a["vocab"], 512), remat=False)
    if a["n_experts"]:
        a.update(n_experts=4, top_k=min(a["top_k"], 2))
    if a["attn_every"]:
        a.update(attn_every=1)
    if a["enc_len"]:
        a.update(enc_len=16)
    if a["n_patches"]:
        a.update(n_patches=8)
    return a


def make_root(tmp: Path, workload: str = "edge4.steady120", *, limit: float = 1.0,
              rate: float | None = None, seq_len: int = 16, dtype: str = "float32") -> Path:
    """A checkout-like folder holding BENCHMARK.json, the cell's configuration
    (in ``dtype``) and traffic at smoke size, the metric readers and the
    reference modules."""
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, workload)
    cfg = spec.load_config(bench, cell["config"])
    cfg["dtype"] = dtype
    cfg["archs"] = {n: {**reduce_arch(a), "dtype": dtype} for n, a in cfg["archs"].items()}
    cfg["limits"] = {n: limit for n in cfg["archs"]}
    traffic = spec.load_traffic(cell["traffic"])
    traffic.update(seq_len=seq_len, rate=rate or traffic["rate"] / 10, segment_s=2, warmup_s=1)
    pb = Path(tmp) / "portbench"
    for sub in ("configs", "traffic"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "archs"):
        shutil.copytree(spec.HERE / sub, pb / sub, dirs_exist_ok=True)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    (Path(tmp) / entry["file"]).write_text(json.dumps(cfg))
    (pb / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(traffic))
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(bench))
    return Path(tmp)
