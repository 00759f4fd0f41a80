"""Tracing and metrics (counterpart of ``mistral_inference_tpu/utils/profiling.py``).

A ``torch.profiler`` trace context for the host's and the card's timelines,
a wall-clock step timer, and the process-wide metrics registry that the
serving engine publishes into.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Union

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: Union[str, Path], device: Union[str, torch.device] = "cuda") -> Iterator[profile]:
    """Profile the block: host calls, and the card's kernels unless
    ``device`` is the CPU. Writes ``trace.json`` (Chrome trace format, for
    Perfetto) into ``log_dir``; yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclass
class StepTimer:
    """Wall-clock timing of prefill and decode: ``ttft`` is the prefill
    time, ``tokens_per_s`` counts decode time only. The caller synchronizes
    the card before each mark: PyTorch returns before the card finishes."""

    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_tokens: int = 0
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def end_prefill(self) -> None:
        self.prefill_s += time.perf_counter() - self._t0

    def end_decode(self, n_tokens: int) -> None:
        self.decode_s += time.perf_counter() - self._t0
        self.decode_tokens += n_tokens

    @property
    def ttft(self) -> float:
        return self.prefill_s

    @property
    def tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "ttft_s": self.prefill_s,
            "decode_s": self.decode_s,
            "decode_tokens": self.decode_tokens,
            "tokens_per_s": self.tokens_per_s,
        }


class Metrics:
    """Process-wide counters, gauges and samples (latencies, sizes); dumps
    as one JSON line."""

    MAX_SAMPLES = 1024  # per series: bounded memory on a long-lived server

    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.samples: Dict[str, List[float]] = defaultdict(list)

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] += v

    def set(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        """Record a sample (e.g. one request's time to first token)."""
        s = self.samples[name]
        s.append(v)
        if len(s) > self.MAX_SAMPLES:
            del s[: len(s) - self.MAX_SAMPLES]

    def percentile(self, name: str, q: float) -> float:
        """The q-quantile (0 <= q <= 1) of a series, nearest rank below."""
        s = sorted(self.samples[name])
        return s[min(len(s) - 1, int(q * len(s)))]

    def dump(self) -> str:
        stats = {
            name: {
                "count": len(s),
                "p50": self.percentile(name, 0.5),
                "p90": self.percentile(name, 0.9),
                "p99": self.percentile(name, 0.99),
                "max": max(s),
            }
            for name, s in self.samples.items()
            if s
        }
        return json.dumps({"counters": dict(self.counters), "gauges": self.gauges, "stats": stats})


METRICS = Metrics()
