"""CPU tests of the benchmark's harness: traffic, tails and rates, the work
arithmetic, the import check, cells from files alone, and the trace
reduction. ``python -m pytest perfbench/tests -q`` from the checkout's root."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import textwrap
from collections import Counter

import pytest

import tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench import drive, stats, tracing, traffic
from perfbench import work as WK
from perfbench import weights as W
from perfbench.run import forbidden_modules
from perfbench.spec import ROOT


def _mix(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())


def test_traffic_repeats_per_seed_and_keeps_its_sizes_across_seeds():
    mix = _mix("chat-open")
    a = traffic.make_traffic(mix, 2**31 + 12345, 32000, 300)
    b = traffic.make_traffic(mix, 2**31 + 12345, 32000, 300)
    c = traffic.make_traffic(mix, 7, 32000, 300)
    assert [r.prompt for r in a.requests] == [r.prompt for r in b.requests]
    assert [r.gap_s for r in a.requests] == [r.gap_s for r in b.requests]
    assert [r.prompt for r in a.requests] != [r.prompt for r in c.requests]
    # Each block of 64 offers the same sizes and gaps whatever the seed.
    for blk in range(4):
        sl = slice(64 * blk, 64 * (blk + 1))
        for key in (lambda r: r.max_tokens, lambda r: round(r.gap_s, 12),
                    lambda r: r.prefix_id is None,
                    lambda r: len(r.prompt) - (1024 if r.prefix_id is not None else 0)):
            assert Counter(map(key, a.requests[sl])) == Counter(map(key, c.requests[sl]))
    shared = [r for r in a.requests[:256] if r.prefix_id is not None]
    assert len(shared) == 128  # half of each block
    assert all(r.prompt[:1024] == shared[0].prompt[:1024] for r in shared
               if r.prefix_id == shared[0].prefix_id)
    assert max(len(r.prompt) + r.max_tokens for r in a.requests) <= 4608
    # The lognormal quantiles have the stated median and clip.
    q = traffic.lognormal_quantiles(mix["max_tokens"], 64)
    assert q.min() >= 16 and q.max() <= 512 and abs(sorted(q)[32] - 160) < 15


def _log(recs, steps=(), w0=10.0, w1=20.0, end=25.0):
    return drive.RunLog(recs, list(steps), 0.0, w0, w1, end, end, "open")


def test_tails_take_every_request_and_unanswered_ones_fail_at_the_cap():
    recs = [drive.Rec(i, 10, 4, due=10.0 + i, times=[10.5 + i]) for i in range(9)]
    recs.append(drive.Rec(9, 10, 4, due=19.0))  # never answered
    recs.append(drive.Rec(10, 10, 4, due=5.0, times=[30.0]))  # due in the ramp: not counted
    log = _log(recs)
    t = stats.ttfts(log)
    assert len(t) == 10 and stats.failed(log) == 1
    assert max(t) == pytest.approx(25.0 - 19.0)  # at the drain's end
    assert stats.percentile(t, 0.9) == pytest.approx(0.5)  # 9 of 10 answered in 0.5 s
    assert stats.percentile(t, 1.0) == pytest.approx(6.0)
    assert stats.percentile([3.0], 0.9) == 3.0 and stats.percentile([], 0.9) is None


def _stepped(period, first, n_steps, rows=8, stall_at=None, stall=0.0):
    """Back-to-back steps of ``period`` s from ``first``, each handing one
    token to each of ``rows`` requests at its end; the step that starts at or
    after ``stall_at`` takes ``stall`` s longer."""
    steps, t = [], first
    for _ in range(n_steps):
        d = period + (stall if stall_at is not None and stall_at <= t < stall_at + period else 0.0)
        steps.append(drive.Step(t, t + d, 0.0, {"decode": 1, "prefill": 0}))
        t += d
    recs = [drive.Rec(i, 10, n_steps, due=first, times=[s.end for s in steps]) for i in range(rows)]
    return recs, steps


def test_rates_and_gaps_are_over_the_whole_window_so_a_stall_moves_them():
    run = lambda log: stats.Run(log, 1.0, (log.w0, log.w1))  # noqa: E731
    from perfbench.spec import metric_reader
    rate = metric_reader("output_tokens_per_s")
    smooth = _log(*_stepped(0.125, 9.0, 112, rows=10))
    stalled = _log(*_stepped(0.125, 9.0, 112, rows=10, stall_at=15.0, stall=2.0))
    assert rate(run(smooth)) == pytest.approx(80.0)
    assert rate(run(stalled)) == pytest.approx(64.0)  # 64 steps of 10 tokens in the 10 s
    assert (stats.percentile(stats.tpots(stalled), 0.9)
            > stats.percentile(stats.tpots(smooth), 0.9) * 1.1)
    # Blocks of 0.8 s that hand over 64 tokens at once read 80 tokens/s
    # wherever the window's edges cut them, not 76.8 or 83.2.
    for first in (9.05, 9.3, 9.55, 9.75):
        recs, steps = _stepped(0.8, first, 20, rows=64)
        assert rate(run(_log(recs, steps))) == pytest.approx(80.0)
    assert rate(run(_log([]))) is None


def _dims(name):
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    return W.dims(cfg)


def test_work_of_one_layer_matches_hand_counts():
    d = _dims("mistral-7b-int4-fp8")
    assert (d.dim, d.head_dim, d.n_kv_heads, d.hidden, d.window) == (4096, 128, 8, 14336, 4096)
    # wqkv at 64 rows: 4096 -> 6144, int4 with group-128 fp32 scales.
    f, b = WK.linear_work(4096, 6144, 4, 128, 64)
    assert f == 2 * 64 * 4096 * 6144
    assert b == 4096 * 6144 / 2 + 32 * 6144 * 4 + 64 * (4096 + 6144) * 2
    # One decode row at fill 99: 100 visible slots of an fp8 ring.
    f, b = WK.attn_decode_work(d, [99], 4608)
    assert f == 4 * 32 * 128 * 100
    slot = 8 * (2 * 128 * 1 + 2 * 4)
    assert b == 2 * 32 * 128 * 2 + 2 * 8 * 128 * 2 + slot + 100 * slot
    # Past the window a row sees 4096 slots.
    assert WK.attn_decode_work(d, [5000], 4608)[0] == 4 * 32 * 128 * 4096
    # A 3-token chunk over a 2-token fill sees 3, 4 and 5 keys.
    f, _ = WK.attn_prefill_work(d, [(2, 3)], 4608)
    assert f == 4 * 32 * 128 * (3 + 4 + 5)
    # Near the window's end: fill 4094, 4 tokens see 4095, 4096, 4096, 4096.
    assert WK.attn_prefill_work(d, [(4094, 4)], 4608)[0] == 4 * 32 * 128 * (4095 + 3 * 4096)
    per_layer = 4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336
    assert WK.layer_params(d) == per_layer
    m = _dims("mixtral-8x7b-int4")
    assert (m.experts, m.top_k, m.window, m.kv_quant) == (8, 2, None, "int8")
    assert WK.layer_params(m) == 4096 * 6144 + 4096 * 4096 + 8 * 4096 + 2 * 3 * 4096 * 14336
    f, b = WK.moe_work(m, 64, 8)
    assert f == 2 * 64 * 2 * 3 * 4096 * 14336
    expert = (4096 * 28672 / 2 + 32 * 28672 * 4) + (14336 * 4096 / 2 + 112 * 4096 * 4)
    assert b == 8 * expert + 64 * 2 * 4096 * 2 + 64 * 2 * 3 * 14336 * 2
    # A whole Mixtral in int4: 32 layers of experts near the 25.2 GB the port holds.
    assert 23e9 < 32 * 8 * expert < 25.2e9
    p = WK.peaks_for("NVIDIA H100 80GB HBM3")
    assert WK.least_seconds(989e12, 0, p) == pytest.approx(1.0)
    assert WK.least_seconds(0, 3.35e12, p) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        WK.peaks_for("NVIDIA A100-SXM4-80GB")


def test_import_check_compares_whole_top_level_names():
    assert forbidden_modules(["mistral_inference_tpu_torch", "mistral_inference_tpu_torch.ops",
                              "jaxtyping", "flaxen.x", "numpy"]) == []
    assert forbidden_modules(["mistral_inference_tpu.model", "jax.numpy", "flax"]) == [
        "flax", "jax", "mistral_inference_tpu"]


def test_the_harness_imports_nothing_of_jax_or_the_jax_package():
    code = textwrap.dedent(f"""
        import sys; sys.path.insert(0, {str(ROOT)!r})
        import perfbench.run, perfbench.check, perfbench.tracing, perfbench.drive
        import perfbench.references.transformer
        from perfbench import spec
        spec.reference_module("transformer"); spec.system_module("transformer")
        import mistral_inference_tpu_torch.server.engine
        print(perfbench.run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    # The reference imports nothing of the program.
    src = (ROOT / "perfbench" / "references" / "transformer.py").read_text()
    assert "mistral_inference_tpu" not in src and "jax" not in src


def test_a_config_a_mix_and_a_metric_are_added_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench" / "configs" / "mistral-7b-int4-fp8.json").read_text())
    cfg["num_hidden_layers"] = 2
    (tmp_path / "perfbench" / "configs" / "mistral-2l.json").write_text(json.dumps(cfg))
    mix = _mix("chat-open")
    mix["rate_per_s"] = 9.0
    (tmp_path / "perfbench" / "traffic" / "chat-fast.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench" / "metrics" / "requests_due.py").write_text(
        "def read(run):\n    return float(len(run.log.recs))\n")
    bench["configs"].append({"name": "mistral-2l", "source": "x", "reduced": ["num_hidden_layers"],
                             "file": "perfbench/configs/mistral-2l.json", "why": "x"})
    bench["workloads"].append({"name": "mistral-2l.chat-fast", "config": "mistral-2l",
                               "traffic": "chat-fast", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_due", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "ttft_p90_s",
                               "workloads": ["mistral-2l.chat-fast"]})
    bench["end_to_end"][0]["workloads"].append("mistral-2l.chat-fast")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys; sys.path.insert(0, {str(tmp_path)!r})
        from perfbench import spec, traffic, weights
        c = spec.load_cell("mistral-2l.chat-fast")
        d = weights.dims(c.config)
        t = traffic.make_traffic(c.mix, 3, d.vocab, 10)
        class R: pass
        r = R(); r.log = R(); r.log.recs = [1, 2, 3]
        read = {{m.name: m.read for m in c.per_layer}}["requests_due"]
        print(json.dumps([d.n_layers, c.mix["rate_per_s"], len(t.requests),
                          [m.name for m in c.per_layer], read(r),
                          [m.name for m in c.end_to_end]]))
    """)
    out = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                    cwd=tmp_path, check=True).stdout)
    assert out[:3] == [2, 9.0, 10]
    assert out[3] == ["requests_due"] and out[4] == 3.0
    assert out[5] == ["ttft_p90_s", "setup_s"]


class _Ev:
    """A profiler event as ``analyse`` reads it."""

    def __init__(self, kind, name, s, e, corr=0):
        self._k, self._n, self._s, self._e, self._c = kind, name, s, e, corr

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def test_trace_reduction_takes_the_union_and_attributes_by_launch():
    import torch

    assert tracing.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    d = _dims("mistral-7b-int4-fp8")
    st = tracing.State(drive.Counters())
    st.fwd.append(tracing.Fwd("decode", torch.tensor([1, 1, 0]), torch.tensor([9, 19, 5])))
    st.lin.append((4096, 6144, 4, 128, 0, 3))
    ev = [
        _Ev("user_annotation", "pb.slice", 0, 1000),
        _Ev("user_annotation", "pb.fwd_decode#0", 100, 600),
        _Ev("user_annotation", "pb.qlinear#0", 150, 250),
        _Ev("cpu_op", "aten::mm", 160, 170), _Ev("cpu_op", "aten::add", 300, 310),
        _Ev("cpu_op", "aten::cat", 700, 710),
        _Ev("cuda_runtime", "cudaLaunchKernel", 200, 201, corr=1),
        _Ev("cuda_runtime", "cudaLaunchKernel", 400, 401, corr=2),
        _Ev("kernel", "k3", 300, 400, corr=1), _Ev("kernel", "add", 350, 500, corr=2),
        _Ev("kernel", "late", 900, 1100, corr=3),  # no launch seen; clipped at the slice
    ]
    sl = tracing.Slice(st, 0, 0, "cpu")
    sl.events = ev
    t = tracing.analyse(sl, st, d, 4608, WK.peaks_for("NVIDIA H100 80GB HBM3"))
    assert t["window_s"] == pytest.approx(1e-6)
    assert t["busy_s"] == pytest.approx(300e-9)  # 300..500 and 900..1000
    assert t["device_s"]["qlinear_decode"] == pytest.approx(100e-9)
    assert t["span_s"]["decode"] == pytest.approx(200e-9)  # 300..500
    assert t["decode_host_ops"] == 2 and t["decode_forwards"] == 1
    assert t["attributed"] == pytest.approx(2 / 3)
    least = WK.least_seconds(*WK.linear_work(4096, 6144, 4, 128, 2), WK.PEAKS[
        "NVIDIA H100 80GB HBM3"])
    assert t["least_s"]["qlinear_decode"] == pytest.approx(least)
    # 0..300 while the linear's range was open, 500..900 outside any range
    assert dict(t["idle_gaps"]) == pytest.approx({"pb.qlinear": 300e-9,
                                                  "host.outside_ranges": 400e-9})
    assert t["flops"]["decode"] == pytest.approx(WK.decode_forward_flops(d, [9, 19], 4608))
    assert math.isfinite(t["flops"]["decode"])


class _OldEv:
    """An event of a PyTorch whose events carry no ``activity_type``."""

    def __init__(self, name, cuda):
        import torch

        self._n = name
        self._d = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d


def test_events_without_an_activity_type_are_told_apart_by_device_and_name():
    assert [tracing._kind(_OldEv(n, c)) for n, c in [
        ("pb.fwd_decode#3", False), ("pb.fwd_decode#3", True), ("aten::mm", False),
        ("cudaLaunchKernel", False), ("cuLaunchKernel", False), ("void k3<4>(...)", True),
        ("Memcpy DtoH (Device -> Pinned)", True)]] == [
        "user_annotation", "gpu_user_annotation", "cpu_op", "cuda_runtime", "cuda_runtime",
        "kernel", "kernel"]
