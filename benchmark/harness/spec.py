"""What `BENCHMARK.json` says of one cell, and the files the harness finds
by name: `configs/<config>.json` (the entry's `file`),
`traffic/<traffic>.json`, `limits/<workload>.json` and one reader
`metrics/<metric>.py` per metric."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`; raises KeyError for an unknown name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def reader(metric: str, root: Path = ROOT):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    mod_name = "benchmark.metrics._" + metric.replace(".", "_").replace(
        "-", "_")
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    if module_spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric '{metric}' at {path}")
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
