"""The load generator and the client: one thread that submits each request
when it is due, steps the engine, and stamps every token with the host
clock when ``Engine.step`` hands it over.

Open loop: request i is due at the ramp's start plus its gaps so far,
whatever the engine is doing, and is timed from then; a request is submitted
at the first step boundary at or after it is due, and the lateness is kept.
Closed loop: each client sends its next request as soon as its previous one
has finished; client c starts at c * start_spread_s / clients.

The window is [ramp start + ramp_s, + seconds). Requests due after it are
not sent. After it the engine runs on until every request due inside it has
its first token, or until the mix's drain cap.
"""

from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from perfbench.traffic import Traffic


@dataclass
class Rec:
    index: int
    prompt_len: int
    max_tokens: int
    due: float
    submitted: float = 0.0
    rid: int = -1
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)  # the program's, of each token
    finished: Optional[float] = None
    error: bool = False
    client: int = -1


@dataclass
class Step:
    start: float
    end: float
    admission_s: float  # the engine's own admission timer, summed over this step
    forwards: Dict[str, int]  # decode / prefill forwards this step ran


@dataclass
class RunLog:
    recs: List[Rec]
    steps: List[Step]
    t0: float  # the ramp's start
    w0: float  # the window's start
    w1: float  # the window's end
    end: float  # the drain's end
    drain_cap: float
    loop: str


class Counters:
    """Forwards counted at ``model.forward`` by kind: the benchmark's own
    wrapper (``tracing.wrap_forward``) adds to it."""

    def __init__(self) -> None:
        self.forwards = {"decode": 0, "prefill": 0}


def drive(engine, traffic: Traffic, seconds: float, counters: Counters,
          on_step: Optional[Callable[[float, bool], Any]] = None,
          on_start: Optional[Callable[[float, float], Any]] = None) -> RunLog:
    """Run the traffic through ``engine`` for the ramp, the window and the
    drain. ``on_start(w0, w1)`` learns the window; ``on_step(now, before)``
    is called around each step (the traced run starts and stops its
    profiler there)."""
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    reqs = traffic.requests
    recs: List[Rec] = []
    by_rid: Dict[int, Rec] = {}
    steps: List[Step] = []
    t0 = time.perf_counter()
    w0 = t0 + traffic.ramp_s
    w1 = w0 + seconds
    cap = w1 + traffic.drain_cap_s
    if on_start is not None:
        on_start(w0, w1)

    # Open loop: due times from the gaps. Closed loop: each client's next
    # start, and the shared queue of requests in order.
    open_loop = traffic.loop == "open"
    schedule: list = []  # a heap of (due, tie, request or None, client)
    tie = itertools.count()
    if open_loop:
        t = t0
        for r in reqs:
            t += r.gap_s
            if t >= w1:
                break
            schedule.append((t, next(tie), r, -1))
    else:
        pool = deque(reqs)
        for c in range(traffic.clients):
            schedule.append((t0 + c * traffic.start_spread_s / traffic.clients, next(tie), None, c))
    heapq.heapify(schedule)

    def submit(due: float, r, client: int) -> None:
        if r is None:
            if not pool:
                raise RuntimeError("the closed loop ran out of requests: raise "
                                   "requests_per_client in the mix")
            r = pool.popleft()
        rec = Rec(r.index, len(r.prompt), r.max_tokens, due, client=client)
        rec.submitted = time.perf_counter()
        rec.rid = engine.submit(r.prompt, max_tokens=r.max_tokens)
        by_rid[rec.rid] = rec
        recs.append(rec)

    def waiting_first_token() -> bool:
        return any(not rec.times and not rec.error and w0 <= rec.due < w1 for rec in recs)

    while True:
        now = time.perf_counter()
        while schedule and schedule[0][0] <= now:
            due, _, r, client = heapq.heappop(schedule)
            if due < w1:
                submit(due, r, client)
        if now >= w1 and (now >= cap or not waiting_first_token()):
            break
        if not engine.has_work:
            nxt = schedule[0][0] if schedule else None
            if nxt is None or nxt >= w1:
                if now >= w1:
                    break
                time.sleep(0.001)
            else:
                time.sleep(min(max(0.0, nxt - now), 0.01))
            continue
        if on_step is not None:
            on_step(now, True)
        fwd = dict(counters.forwards)
        METRICS.samples["admission_prefill_s"].clear()
        start = time.perf_counter()
        events = engine.step()
        end = time.perf_counter()
        adm = sum(METRICS.samples["admission_prefill_s"])
        steps.append(Step(start, end, adm, {k: counters.forwards[k] - fwd[k] for k in fwd}))
        for ev in events:
            rec = by_rid[ev.request_id]
            if ev.token < 0:
                rec.error = True
            else:
                rec.times.append(end)
                rec.tokens.append(int(ev.token))
                rec.logprobs.append(float(ev.logprob))
            if ev.finished:
                rec.finished = end
                if not open_loop and end < w1:
                    heapq.heappush(schedule, (end, next(tie), None, rec.client))
        if on_step is not None:
            on_step(end, False)
    return RunLog(recs, steps, t0, w0, w1, time.perf_counter(), cap, traffic.loop)
