"""The traced run's instruments, all from the benchmark's own files.

``install`` wraps, from outside the program, the calls whose device time a
per-layer metric reads: ``model.forward`` (decode or prefill forward), the
quantized linears at ``ops/linear.linear`` (as ``models.transformer`` calls
it), the attention entry points, the MoE feed-forwards ``_moe_ffn_dispatch``
and ``_moe_ffn_ragged``, and the engine's dispatch, drain and admission. A
wrapper counts forwards always and, while the profiler runs, opens a
``record_function`` range named ``pb.<kind>#<record>`` and keeps a record of
the call's shapes. After the slice, ``analyse`` reads the profiler's events
in memory (nothing is written to disk): each device operation is attributed
to the ranges open on the host when it was launched (by the launch's
correlation id), the device's busy time is the union of its operations'
intervals, and the work of each call is counted by ``work.py`` from the
records.

Routing counts for the MoE work are computed on the card beside the call,
inside a ``pb.meter`` range whose host ops are not counted and whose
operations are attributed to no call (they do count in the forward's span).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench import work as WK
from perfbench.drive import Counters
from perfbench.weights import Dims

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
CALLS = ("qlinear", "attn_decode", "attn_prefill", "moe_decode", "moe_prefill")


@dataclass
class Fwd:
    kind: str  # "decode" | "prefill"
    seqlens: torch.Tensor  # (B,) tokens a row, cloned at the call
    fills: torch.Tensor  # (B,) ring fill before the call
    real: Optional[torch.Tensor] = None  # (B T,) 1.0 where a position holds a token


@dataclass
class State:
    counters: Counters
    profiling: bool = False
    fwd: List[Fwd] = field(default_factory=list)
    current: int = -1  # the forward the calls belong to
    # K, N, bits, group, forward, rows at the call
    lin: List[Tuple[int, int, int, int, int, int]] = field(default_factory=list)
    moe: List[Tuple[str, int, torch.Tensor]] = field(default_factory=list)  # kind, fwd, counts


def _kind(e) -> str:
    """The profiler's activity kind of an event. Older PyTorch events lack
    ``activity_type``: then the device side is a device operation unless it
    carries one of the benchmark's range names, and the host side is told by
    name (ranges ``pb.``, operators ``aten::``, CUDA runtime and driver
    calls ``cuda*`` / ``cu*``)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if name.startswith("pb.") else "kernel"
    if name.startswith("pb."):
        return "user_annotation"
    if name.startswith("aten::"):
        return "cpu_op"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "other"


def _bits(leaf) -> Tuple[int, int, int, int]:
    q = leaf["q4"] if "q4" in leaf else leaf["q"]
    bits = 4 if "q4" in leaf else 8
    K = q.shape[-2] * (2 if bits == 4 else 1)
    N = leaf["scale"].shape[-1]
    return K, N, bits, K // leaf["scale"].shape[-2]


def install(system: Dict[str, Any], counters: Counters, traced: bool) -> State:
    """Count forwards at ``model.forward``; with ``traced`` also wrap the
    measured calls for the profiler's slice."""
    from torch.autograd.profiler import record_function

    from mistral_inference_tpu_torch.models import transformer as tf

    st = State(counters)
    model, engine = system["model"], system["engine"]
    forward = model.forward

    def fwd_wrapper(tokens, seqlens, cache, *a, **kw):
        kind = "decode" if tokens.shape[1] == 1 else "prefill"
        counters.forwards[kind] += 1
        if not st.profiling:
            return forward(tokens, seqlens, cache, *a, **kw)
        with record_function("pb.meter"):
            lens = seqlens.to(model.device).clone()
            T = tokens.shape[1]
            real = (torch.arange(T, device=lens.device)[None, :] < lens[:, None]).reshape(-1)
            st.fwd.append(Fwd(kind, lens, cache.kv_len.clone(), real.float()))
        st.current = len(st.fwd) - 1
        with record_function(f"pb.fwd_{kind}#{st.current}"):
            return forward(tokens, seqlens, cache, *a, **kw)

    model.forward = fwd_wrapper
    if not traced:
        return st

    def ranged(name: str, fn):
        def wrapper(*a, **kw):
            if not st.profiling:
                return fn(*a, **kw)
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    linear = tf.linear

    def lin_wrapper(x, w, rows=None):
        if not st.profiling or not isinstance(w, dict):
            return linear(x, w, rows)
        K, N, bits, grp = _bits(w)
        st.lin.append((K, N, bits, grp, st.current, x.numel() // x.shape[-1]))
        with record_function(f"pb.qlinear#{len(st.lin) - 1}"):
            return linear(x, w, rows)

    def routed(x, gate, k):
        """Per expert, the real rows routed to it (no host sync)."""
        top = torch.nn.functional.linear(x, gate).topk(k, dim=-1).indices  # (B T, k)
        real = st.fwd[st.current].real[:, None].expand(-1, k)
        return torch.zeros(gate.shape[0], device=x.device).index_add_(
            0, top.reshape(-1), real.reshape(-1))

    dispatch, ragged = tf._moe_ffn_dispatch, tf._moe_ffn_ragged

    def moe_wrapper(fn, kind):
        def wrapper(x, w, top_k, *a, **kw):
            if not st.profiling or (kind == "moe_decode" and x.shape[0] > tf.MOE_RAGGED_ROWS):
                return fn(x, w, top_k, *a, **kw)
            with record_function("pb.meter"):
                st.moe.append((kind, st.current, routed(x, w["gate"], top_k)))
            with record_function(f"pb.{kind}#{len(st.moe) - 1}"):
                return fn(x, w, top_k, *a, **kw)
        return wrapper

    tf.linear = lin_wrapper
    tf._moe_ffn_dispatch = moe_wrapper(dispatch, "moe_decode")
    tf._moe_ffn_ragged = moe_wrapper(ragged, "moe_prefill")
    tf.fused_update_decode_attention = ranged("pb.attn_decode", tf.fused_update_decode_attention)
    for name in ("flash_attention", "ring_attention_stats", "merge_attention_parts",
                 "update_stacked", "kv_roundtrip"):
        setattr(tf, name, ranged("pb.attn_prefill", getattr(tf, name)))
    for name in ("_dispatch_block", "_drain", "_admit"):
        setattr(engine, name, ranged(f"pb.engine{name}", getattr(engine, name)))
    return st


class Slice:
    """The profiler over a steady slice of the window: started at the first
    step boundary at or after ``start``, stopped at the first at or after
    ``stop``, with the card synchronized before it stops so that every
    operation launched inside it is recorded. Made in set-up, where it runs
    the profiler once over nothing: its first start on the card takes
    seconds (the tracing library's set-up), which would otherwise eat the
    slice."""

    def __init__(self, state: State, start: float, stop: float, device):
        from torch.profiler import ProfilerActivity, profile

        self.st, self.start, self.stop, self.device = state, start, stop, device
        self.prof = None
        self.range = None
        self.t = (0.0, 0.0)
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device=device).add_(1)

    def on_step(self, now: float, before: bool) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        if before and self.prof is None and now >= self.start and self.t[1] == 0.0:
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.range = record_function("pb.slice")
            self.range.__enter__()
            self.st.profiling = True
            self.t = (now, 0.0)
        elif not before and self.prof is not None and now >= self.stop:
            self.st.profiling = False
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            self.range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.t = (self.t[0], now)
            self.events = self.prof.profiler.kineto_results.events()
            self.prof = None


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_ns(iv: List[Tuple[int, int]]) -> int:
    """The length of the union of intervals: time in which at least one
    operation ran (the busy time of a device whose streams may overlap)."""
    return sum(e - s for s, e in _merge(iv))


def _stab(ranges: List[Tuple[int, int, str]], points: List[int]) -> List[Tuple[str, ...]]:
    """For each point, the names of the ranges open at it, outermost first.
    Ranges nest (one thread opens them all)."""
    ev = []
    for i, (s, e, _) in enumerate(ranges):
        ev.append((s, 0, i))
        ev.append((e, 2, i))
    for j, p in enumerate(points):
        ev.append((p, 1, j))
    ev.sort()
    open_: List[int] = []
    out: List[Tuple[str, ...]] = [()] * len(points)
    for _, kind, i in ev:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        else:
            out[i] = tuple(ranges[r][2] for r in open_)
    return out


def analyse(sl: Slice, st: State, d: Dims, span: int, peaks: WK.Peaks) -> Dict[str, Any]:
    """The slice's numbers: busy and window seconds, the breakdown, and for
    each measured call and forward kind its least and device seconds."""
    ranges, cpu_ops, launch, dev = [], [], {}, []
    for e in sl.events:
        kind = _kind(e)
        if kind == "user_annotation" and e.name().startswith("pb."):
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        elif kind == "cpu_op":
            cpu_ops.append(e.start_ns())
        elif kind in LAUNCH_KINDS:
            launch[e.correlation_id()] = e.start_ns()
        elif kind in DEVICE_KINDS:
            dev.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id(),
                        e.linked_correlation_id()))
    sl_rng = [r for r in ranges if r[2] == "pb.slice"]
    if not sl_rng or not dev:
        return {}
    s0, s1 = sl_rng[0][0], sl_rng[0][1]
    ranges = [r for r in ranges if r[2] != "pb.slice"]

    # Device busy time and the breakdown.
    clipped = [(max(s, s0), min(e, s1)) for s, e, *_ in dev if e > s0 and s < s1]
    merged = _merge(clipped)
    busy = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name, *_ in dev:
        by_name[name[:160]] += (e - s) / 1e9
    gaps, prev = [], s0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if s1 > prev:
        gaps.append((prev, s1))
    host = _stab(ranges, [(a + b) // 2 for a, b in gaps])
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), names in zip(gaps, host):
        inner = names[-1].split("#")[0] if names else "host.outside_ranges"
        idle[inner] += (b - a) / 1e9

    # Attribute each device operation to the ranges open at its launch.
    pts, which = [], []
    for i, (_, _, _, c, lc) in enumerate(dev):
        t = launch.get(c, launch.get(lc))
        if t is not None:
            pts.append(t)
            which.append(i)
    owners = _stab(ranges, pts)
    call_dev: Dict[str, float] = defaultdict(float)
    fwd_iv: Dict[int, List[int]] = {}
    for i, names in zip(which, owners):
        s, e = dev[i][0], dev[i][1]
        for n in names:
            base, _, idx = n.partition("#")
            kind = base[3:]
            if kind in CALLS:
                call_dev[kind] += (e - s) / 1e9
            elif kind.startswith("fwd_"):
                lo_hi = fwd_iv.setdefault(int(idx), [s, e])
                lo_hi[0], lo_hi[1] = min(lo_hi[0], s), max(lo_hi[1], e)

    # Host ops inside decode forwards, less the benchmark's own metering.
    op_names = _stab(ranges, cpu_ops)
    dec_ops = sum(1 for names in op_names
                  if any(n.startswith("pb.fwd_decode") for n in names)
                  and not any(n == "pb.meter" for n in names))
    n_dec = sum(1 for r in ranges if r[2].startswith("pb.fwd_decode"))

    # Work from the records.
    fwd = [(f.kind, f.seqlens.cpu().tolist(), f.fills.cpu().tolist()) for f in st.fwd]
    least: Dict[str, float] = defaultdict(float)
    flops: Dict[str, float] = defaultdict(float)
    span_s: Dict[str, float] = defaultdict(float)
    for i, (kind, lens, fills) in enumerate(fwd):
        if kind == "decode":
            live = [L for L, n in zip(fills, lens) if n > 0]
            f_a, b_a = WK.attn_decode_work(d, live, span)
            least["attn_decode"] += d.n_layers * WK.least_seconds(f_a, b_a, peaks)
            model_flops = WK.decode_forward_flops(d, live, span)
        else:
            chunks = [(L, n) for L, n in zip(fills, lens) if n > 0]
            f_a, b_a = WK.attn_prefill_work(d, chunks, span)
            least["attn_prefill"] += d.n_layers * WK.least_seconds(f_a, b_a, peaks)
            model_flops = WK.prefill_forward_flops(d, chunks, span)
        if i in fwd_iv:  # a forward's operations count with its device span
            flops[kind] += model_flops
            span_s[kind] += (fwd_iv[i][1] - fwd_iv[i][0]) / 1e9
    for K, N, bits, grp, fi, rows in st.lin:
        kind, lens, _ = fwd[fi]
        real = sum(1 for n in lens if n > 0) if kind == "decode" else sum(lens)
        call = "qlinear_decode" if rows <= 256 else "qlinear_prefill"
        least[call] += WK.least_seconds(*WK.linear_work(K, N, bits, grp, real), peaks)
    for kind, fi, counts in st.moe:
        c = counts.cpu()
        rows = int(round(float(c.sum()))) // max(1, d.top_k)
        least[kind] += WK.least_seconds(*WK.moe_work(d, rows, int((c > 0).sum())), peaks)

    # Device time of the linears by the rows at the call.
    lin_dev: Dict[str, float] = defaultdict(float)
    for i, names in zip(which, owners):
        for n in names:
            if n.startswith("pb.qlinear#"):
                rows = st.lin[int(n.partition("#")[2])][5]
                lin_dev["qlinear_decode" if rows <= 256 else "qlinear_prefill"] += (
                    dev[i][1] - dev[i][0]) / 1e9
    device = dict(call_dev)
    device.update(lin_dev)
    return {
        "busy_s": busy / 1e9, "window_s": (s1 - s0) / 1e9,
        "attributed": len(which) / len(dev),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        "least_s": dict(least), "device_s": device, "flops": dict(flops),
        "span_s": dict(span_s), "decode_host_ops": dec_ops, "decode_forwards": n_dec,
    }
