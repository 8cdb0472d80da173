"""A cell of BENCHMARK.json and the files it names, found by name:
configs/<config>.json, traffic/<traffic>.json and, for each per-layer
metric the cell reports, metrics/<metric>.py (a module with
`read(readings) -> float | None`).  A new cell is one more entry in
BENCHMARK.json; a new configuration, mix or per-layer metric is one more
file here and one more entry there."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    data: Path              # the folder of configs/, traffic/, metrics/

    def reader(self, metric: str):
        """The read function of metrics/<metric>.py."""
        path = self.data / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_port_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load(name: str, root: Path = HERE.parent, data: Path = HERE) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files under data."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = found[0]
    config = json.loads((data / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((data / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if name in m.get(
        "workloads", [name] if m["moves"] in moved else [])]
    return Cell(name, config, traffic, w["chips"], e2e, layer, data)
