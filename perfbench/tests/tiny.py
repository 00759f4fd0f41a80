"""Cells at a size the CPU holds, for the benchmark's own tests: the tiny
configurations and mixes beside this file under the real cells' metrics."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spec as S  # noqa: E402

OPEN = "mistral-7b-int4-fp8.chat-open"
CLOSED = "mixtral-8x7b-int4.chat-closed"


def cell(config: str, mix: str, name: str) -> S.Cell:
    """The tiny ``config`` and ``mix`` under the metrics of the real cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return S.Cell(name, 1, config, json.loads((HERE / f"{config}.json").read_text()), mix,
                  json.loads((HERE / f"{mix}.json").read_text()),
                  S._metrics(bench["end_to_end"], name), S._metrics(bench["per_layer"], name))


def dense_open() -> S.Cell:
    return cell("tiny-dense", "tiny-open", OPEN)


def moe_closed() -> S.Cell:
    return cell("tiny-moe", "tiny-closed", CLOSED)


def run(c: S.Cell, seed: int, seconds: float = 2.0, trace: bool = False, control: bool = False):
    """A whole run on the CPU past the harness's look for a card."""
    from perfbench.run import run_cell

    return run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(), control=control,
                    log_to=sys.stdout)
