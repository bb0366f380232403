"""One cell of ``BENCHMARK.json``, resolved from the files its names lead to.

A cell names a configuration (``configs[].file``, a JSON file of sizes and
settings), a traffic mix (``perfbench/traffic/<traffic>.json``, whose
``generator`` names a module beside it), and reports the end-to-end
metrics listed for it (an entry with no ``workloads`` key is for every
cell) and the per-layer metrics listed for it (an entry with no
``workloads`` key is for every cell that reports the metric it moves).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    def generator(self):
        return importlib.import_module(f"perfbench.traffic.{self.traffic['generator']}")


def load(root: pathlib.Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(workload, int(cell["chips"]), config, traffic, e2e, per_layer)


def reader(metric_name: str):
    """The reader module of a per-layer metric: the quantity before the
    first dot."""
    return importlib.import_module(f"perfbench.metrics.{metric_name.split('.')[0]}")
