"""What a run reads before it runs: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix file and the metric readers, each found
by the name ``BENCHMARK.json`` gives it. A later cell, configuration, mix or
metric is added by adding files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MIXES = HERE / "traffic"
METRICS = HERE / "metrics"
SYSTEMS = HERE / "systems"
REFERENCES = HERE / "references"


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[Any], Optional[float]]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    mix: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``metrics/<name>.py``'s ``read(run)``: the metric's number from the
    run's record, or None where the run has nothing to read it from."""
    return _load_module(METRICS / f"{name}.py", f"perfbench_metric_{name}").read


def system_module(name: str):
    """``systems/<name>.py``: builds the system under test for a configuration."""
    return _load_module(SYSTEMS / f"{name}.py", f"perfbench_system_{name}")


def reference_module(name: str):
    """``references/<name>.py``: the plain reference of a configuration."""
    return _load_module(REFERENCES / f"{name}.py", f"perfbench_reference_{name}")


def _applies(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _metrics(entries: List[Dict[str, Any]], cell: str) -> List[Metric]:
    return [Metric(e["name"], e["unit"], metric_reader(e["name"]))
            for e in entries if _applies(e, cell)]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell named ``workload``, with everything it names loaded."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((MIXES / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], mix=mix,
        end_to_end=_metrics(bench["end_to_end"], workload),
        per_layer=_metrics(bench["per_layer"], workload),
    )
