"""Numbers from a run's record, as the metric readers take them.

A ``Run`` is what a reader gets: the client's log of every request and
step (``drive.RunLog``), the set-up time, the part of the window the host
metrics read, and in a traced run the slice's analysis (``tracing.analyse``).
Every tail is over all requests; every rate is over the whole window."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from perfbench.drive import RunLog, Step
from perfbench.work import Peaks


@dataclass
class Run:
    log: RunLog
    setup_s: float
    host_span: Tuple[float, float]  # the window less a traced run's profiled slice
    trace: Optional[Dict[str, Any]] = None
    peaks: Optional[Peaks] = None


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-quantile (0 < q <= 1): the ceil(q n)-th smallest."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def due_in_window(log: RunLog) -> List:
    return [r for r in log.recs if log.w0 <= r.due < log.w1]


def ttfts(log: RunLog) -> List[float]:
    """Seconds from each request's due time to its first token, for every
    request due in the window; one that has none when the drain ends (or
    that failed) enters at the drain's end."""
    return [(r.times[0] if r.times and not r.error else log.end) - r.due
            for r in due_in_window(log)]


def failed(log: RunLog) -> int:
    return sum(1 for r in due_in_window(log) if r.error or not r.times)


def tpots(log: RunLog) -> List[float]:
    """Each request's mean gap between its output tokens inside the window:
    (last - first) / (tokens - 1), for requests whose tokens there arrived
    at two times or more (a block hands over its tokens at once)."""
    out = []
    for r in log.recs:
        ts = [t for t in r.times if log.w0 <= t < log.w1]
        if len(set(ts)) >= 2:
            out.append((ts[-1] - ts[0]) / (len(ts) - 1))
    return out


def output_rate(log: RunLog) -> Optional[float]:
    """Tokens per second over the steps that overlap the window: every token
    those steps handed over, over the wall time from the window's start (or
    the first such step's start, if earlier) to its end (or the last such
    step's end, if later). A step hands over a decode block's tokens at once,
    so whole steps are counted with their whole time, and a block cut by the
    window's edge moves the rate by its share of time only."""
    over = [s for s in log.steps if s.end > log.w0 and s.start < log.w1]
    if not over:
        return None
    a, b = min(log.w0, over[0].start), max(log.w1, over[-1].end)
    return sum(1 for r in log.recs for t in r.times if a < t <= b) / (b - a)


def host_steps(run: Run) -> List[Step]:
    a, b = run.host_span
    return [s for s in run.log.steps if s.start >= a and s.end <= b]


def admission_share(run: Run) -> Optional[float]:
    """The engine's own admission timer, summed over the steps of the host
    span, as a share of that span's wall time."""
    a, b = run.host_span
    steps = host_steps(run)
    if b <= a or not steps:
        return None
    return 100.0 * sum(s.admission_s for s in steps) / (b - a)


def trace_share(run: Run, call: str) -> Optional[float]:
    """A call's roofline share from the traced slice: the least time its
    work needs over the device time of the operations it launched."""
    t = run.trace or {}
    dev = t.get("device_s", {}).get(call, 0.0)
    least = t.get("least_s", {}).get(call)
    if not dev or least is None:
        return None
    return 100.0 * least / dev


def mfu(run: Run, kind: str) -> Optional[float]:
    """Model operations of a kind of forward over the device span of those
    forwards (first operation's start to last one's end, idle gaps inside
    included) at the card's bf16 peak."""
    t = run.trace or {}
    span = t.get("span_s", {}).get(kind, 0.0)
    fl = t.get("flops", {}).get(kind)
    if not span or fl is None or run.peaks is None:
        return None
    return 100.0 * fl / (span * run.peaks.bf16_flops)
