"""Tracing and metrics (counterpart of ``mistral_inference_tpu/utils/profiling.py``).

The port's one tracer: ``METRICS``, the process-wide registry of counters,
gauges, samples and spans that the serving engine and the model publish
into, and ``trace()``, a ``torch.profiler`` context for the host's and the
card's timelines.

A span is a named interval on ``time.perf_counter()`` (the clock of
``Request.t_submit``) with its own id, its parent's id (0: none), the ids of
the requests it serves (a decode block's spans: one a row, None for a dead
row) and attributes the host already holds (ints, and a label such as a
sweep's kind). The newest ``SPAN_CAPACITY`` spans are kept
in memory and read with ``spans()``; nothing is written to disk except by
``trace()``. Recording one reads the clock and appends: it never reads a
device tensor, synchronizes or records a CUDA event.

Spans come in two tiers:

* the engine tier (``server/engine.py``: ``engine.*`` and ``request.*``) is
  always on, a dozen spans a step;
* the call tier (``model.forward``, ``ops.linear``, ``attn.*``, ``moe.*``)
  is recorded only while the tracing switch ``TRACING`` is on: ``trace()``
  turns it on for its block, ``set_tracing`` for any other caller. Off, a
  call-tier site costs one check of the flag.

While the switch is on, every span of either tier held by a ``with`` block
also opens a profiler range of its name
(``torch.autograd.profiler.record_function``), so that the span's host
interval lands on the profiler's clock beside the device operations it
launched: in ``trace.json`` each idle gap of the card sits under the spans
the host was in. A request's spans (``request.queued``, ``request.decode``)
outlive the step that opens them and open no range.

A count that a kernel's caller makes on the card (``add_on_device``) stays
there until it is folded into ``counters``: by the engine once a block,
from the copy that brings the block's tokens back, and by ``dump()``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Deque, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# The call tier's switch. Call sites read it as ``profiling.TRACING``.
TRACING = False

# Spans kept: a serving minute at 64 rows records a few thousand engine
# spans; the call tier records about 200 a forward while it is on.
SPAN_CAPACITY = 1 << 16

# What a call-tier site enters with the switch off.
NULL = contextlib.nullcontext()

_clock = time.perf_counter


def set_tracing(on: bool) -> None:
    """Turn the call tier (and the profiler ranges of every span) on or off."""
    global TRACING
    TRACING = bool(on)


class Span:
    """One recorded interval; ``end`` is None while it is open. Entered as a
    context manager (``Metrics.span``) it nests under the innermost span
    open in a ``with`` block, and publishes its length as the sample
    ``sample`` when it closes."""

    __slots__ = ("name", "start", "end", "id", "parent", "rids", "attrs", "_metrics", "_sample",
                 "_range")

    def __init__(self, metrics: "Metrics", name: str, rids: Sequence[Optional[int]],
                 attrs: Dict[str, Any], sample: Optional[str] = None):
        self.name = name
        self.start = 0.0
        self.end: Optional[float] = None
        self.id = metrics._next_id()
        self.parent = 0
        self.rids = rids
        self.attrs = attrs
        self._metrics = metrics
        self._sample = sample
        self._range = None

    def __enter__(self) -> "Span":
        m = self._metrics
        stack = m._stack
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if TRACING:
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        m.spans.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end = _clock()
        m = self._metrics
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        m._stack.pop()
        if self._sample is not None:
            m.observe(self._sample, self.end - self.start)


class Metrics:
    """Process-wide counters, gauges, samples (latencies, sizes) and spans;
    dumps as one JSON line. Spans held by ``with`` blocks nest on one
    stack: open them from the one thread that steps the engine."""

    MAX_SAMPLES = 1024  # per series: bounded memory on a long-lived server

    def __init__(self) -> None:
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.spans: Deque[Span] = deque(maxlen=SPAN_CAPACITY)
        self._stack: List[Span] = []
        self._next_id = itertools.count(1).__next__
        # The real tokens of the next forwards, from a caller that holds
        # them on the host (``expect_tokens``).
        self._tokens: Deque[int] = deque()
        # (name, device) -> a 0-d int64 count on that device
        self._on_device: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self._device_lock = threading.Lock()

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

    # -- spans --------------------------------------------------------------

    def span(self, name: str, rids: Sequence[Optional[int]] = (), sample: Optional[str] = None,
             **attrs: Any) -> Span:
        """A span to enter with ``with``: it starts there, under the
        innermost open one, and ends when the block does."""
        return Span(self, name, rids, attrs, sample)

    def open_span(self, name: str, rids: Sequence[int] = (), start: Optional[float] = None,
                  **attrs: Any) -> Span:
        """A span that no block holds (a request's wait in the queue),
        recorded from ``start`` (now if None) until ``close_span``."""
        sp = Span(self, name, rids, attrs)
        sp.start = time.perf_counter() if start is None else start
        self.spans.append(sp)
        return sp

    @staticmethod
    def close_span(sp: Span, end: Optional[float] = None, parent: Optional[int] = None) -> None:
        sp.end = time.perf_counter() if end is None else end
        if parent is not None:
            sp.parent = parent

    def expect_tokens(self, counts: Sequence[int]) -> None:
        """The real (unpadded) tokens of the next forwards, in their order,
        from a caller that holds them on the host while the forwards' seqlens
        live on the card; each ``model.forward`` span takes one. Replaces
        what is left of an earlier call."""
        self._tokens.clear()
        self._tokens.extend(counts)

    def real_tokens(self, seqlens: torch.Tensor) -> int:
        """A forward's real tokens: the next expected count, else the sum of
        ``seqlens`` if the host holds them, else -1 (unknown)."""
        if self._tokens:
            return self._tokens.popleft()
        return int(seqlens.sum()) if seqlens.device.type == "cpu" else -1

    # -- counts kept on the card --------------------------------------------

    def add_on_device(self, name: str, value: torch.Tensor) -> None:
        """Add ``value`` (a 0-d integer tensor) to the count ``name`` kept
        on its device, without waiting for it."""
        key = (name, value.device)
        with self._device_lock, torch.inference_mode():
            acc = self._on_device.get(key)
            if acc is None:
                acc = self._on_device[key] = torch.zeros((), dtype=torch.int64,
                                                         device=value.device)
            acc.add_(value)

    def take_on_device(self, device: torch.device) -> Optional[Tuple[Tuple[str, ...],
                                                                     torch.Tensor]]:
        """The counts kept on ``device`` (a tensor's device, with its index)
        as (names, one tensor of them on the device), each count zeroed behind the snapshot in the stream's
        order; None if there are none. The caller copies the snapshot to the
        host and passes it to ``fold``."""
        if not self._on_device:
            return None
        with self._device_lock, torch.inference_mode():
            items = [(n, acc) for (n, d), acc in self._on_device.items() if d == device]
            if not items:
                return None
            snap = torch.stack([acc for _, acc in items])
            for _, acc in items:
                acc.zero_()
        return tuple(n for n, _ in items), snap

    def fold(self, names: Sequence[str], values: Union[np.ndarray, torch.Tensor]) -> None:
        """Add a host copy of ``take_on_device``'s snapshot to ``counters``
        (the engine's thread and ``dump()``'s may both fold)."""
        with self._device_lock:
            for n, v in zip(names, np.asarray(values).tolist()):
                self.counters[n] += float(v)

    def fold_on_device(self) -> None:
        """Fold every count kept on a device into ``counters`` now (one read
        from each device)."""
        for device in {d for _, d in list(self._on_device)}:
            taken = self.take_on_device(device)
            if taken is not None:
                self.fold(taken[0], taken[1].cpu())

    def dump(self) -> str:
        self.fold_on_device()
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


def spans() -> List[Span]:
    """The recorded spans, oldest first (those still open have ``end``
    None)."""
    return list(METRICS.spans)


@contextlib.contextmanager
def trace(log_dir: Union[str, Path], device: Union[str, torch.device] = "cuda") -> Iterator[profile]:
    """Profile the block with the tracing switch on: host calls and the
    program's spans as ranges, and the card's kernels unless ``device`` is
    the CPU. Writes ``trace.json`` (Chrome trace format, for Perfetto) into
    ``log_dir``; yields the profiler, whose ``key_averages()`` sums time by
    operator, kernel and span."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    was = TRACING
    set_tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        set_tracing(was)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
