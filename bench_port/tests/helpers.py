"""A benchmark root built in a temporary folder: the repository's
BENCHMARK.json and bench_port data files, plus whatever a test adds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL = {"m": 256, "log_q": 80, "p": 257, "generator": 3, "decomp_size": 3,
         "stdev": 3.2}
DENSE = {"m": 22, "log_q": 80, "p": 23, "generator": 7, "decomp_size": 3,
         "stdev": 3.2}
TINY_MIX = {"mode": "offline, closed loop", "pairs_per_call": 4, "pool": 2,
            "checked_pairs": 2}


def bench_root(tmp: Path) -> tuple[Path, Path]:
    """(root holding BENCHMARK.json, data folder) copied from the repo."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    data = tmp / "bench_port"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "bench_port" / sub, data / sub)
    return tmp, data


def add_cell(root: Path, name: str, config: str, traffic: str,
             like: str = "ct8192_q80.b512"):
    """A BENCHMARK.json entry for cell `name`, reporting every metric that
    cell `like` reports."""
    path = root / "BENCHMARK.json"
    b = json.loads(path.read_text())
    b["workloads"].append({"name": name, "config": config, "traffic": traffic,
                           "chips": 1, "why": "a test cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    path.write_text(json.dumps(b))


def add_config(data: Path, name: str, context: dict):
    cfg = json.loads((data / "configs" / "ct8192_q80.json").read_text())
    cfg.update(name=name, context=context)
    (data / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return cfg


def add_traffic(data: Path, name: str, mix: dict):
    (data / "traffic" / f"{name}.json").write_text(json.dumps(mix))
