"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name through ``BENCHMARK.json``. The system under test is
``mistral_inference_tpu_torch`` on one NVIDIA card: its weights are drawn
from the seed on the card, every shape the traffic uses is warmed up, the
traffic ramps up, and then the window is measured. ``--trace 0`` reports
the cell's end-to-end metrics; ``--trace 1`` profiles a steady slice at the
window's end and reports its per-layer metrics. Either way, the served
tokens are then held against the plain reference (``check.py``), and each
number compared is printed beside its limit.

Options for building the benchmark, which its own runs never pass:
``--control 1`` also reads the control (the reference one precision
below) on the same sample and puts it through the same limits
(``control_correct`` in the result, which has to be false); ``--rate R``
overrides an open-loop mix's rate (the knee sweep).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)  # no module of the benchmark shadows the standard library
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mistral_inference_tpu")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that a run may not hold, compared
    whole: ``mistral_inference_tpu_torch`` is not ``mistral_inference_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             control: bool = False, rate=None, log_to=sys.stderr):
    """One run of ``cell``; returns the result object (without printing)."""
    import torch

    from perfbench import check, drive, stats, tracing, traffic
    from perfbench import spec as S
    from perfbench import work as WK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peaks = WK.peaks_for(kind) if cuda else None
    if cuda:
        from mistral_inference_tpu_torch.ops.cuda import _build

        _build.build_all()
    sysmod = S.system_module(cell.config["system"])
    system = sysmod.build(cell.config, seed, dev)
    d = system["dims"]
    counters = drive.Counters()
    st = tracing.install(system, counters, traced=trace)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sysmod.warm_up(system, seed)
    n = traffic.requests_needed(cell.mix, seconds, rate)
    tr = traffic.make_traffic(cell.mix, seed, d.vocab, n, rate)

    hook = None
    slice_s = min(10.0, 0.25 * seconds)
    if trace:
        hook = tracing.Slice(st, 0.0, 0.0, dev)
    log = drive.drive(system["engine"], tr, seconds, counters,
                      on_step=None if hook is None else hook.on_step,
                      on_start=None if hook is None else
                      (lambda w0, w1: (setattr(hook, "start", w1 - slice_s),
                                       setattr(hook, "stop", w1))))
    if hook is not None:
        hook.on_step(float("inf"), False)  # a slice still open ends here
    if cuda:
        torch.cuda.synchronize(dev)
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    host_end = hook.start if trace and hook.t[0] else log.w1
    run = stats.Run(log, log.w0 - t_start, (log.w0, min(host_end, log.w1)), None, peaks)
    if trace and hook.t[1]:
        run.trace = tracing.analyse(hook, st, d, system["span"], peaks) if cuda else {}
        print(f"trace: {json.dumps({k: v for k, v in run.trace.items() if k not in ('device_ops', 'idle_gaps')})}",
              file=log_to)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    due = stats.due_in_window(log)
    late = [r.submitted - r.due for r in due]
    backlog = sum(1 for r in log.recs if r.due < log.w1 and not (r.times and r.times[0] < log.w1))
    print(f"load: due {len(due)} submitted {len(log.recs)} steps {len(log.steps)} "
          f"lateness_p50_s {stats.percentile(late, 0.5)} "
          f"lateness_max_s {max(late) if late else None} "
          f"waiting_at_window_end {backlog} drain_s {log.end - log.w1:.3f} "
          f"ttft_p50_s {stats.percentile(stats.ttfts(log), 0.5)} "
          f"ttft_p75_s {stats.percentile(stats.ttfts(log), 0.75)} "
          f"tpot_p50_s {stats.percentile(stats.tpots(log), 0.5)} "
          f"finished_in_window {sum(1 for r in log.recs if r.finished and log.w0 <= r.finished < log.w1)}",
          file=log_to)

    from mistral_inference_tpu_torch.utils.profiling import METRICS

    print(f"program counters: {json.dumps(dict(METRICS.counters))}", file=log_to)

    # The program's state is freed before the reference runs on the card.
    seqs = check.sample(log, tr, int(cell.mix["sample_requests"]), seed)
    errors = sum(1 for r in log.recs if r.error)
    del system, st, hook
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.compare(S.reference_module(cell.config["reference"]), cell.config, seed,
                            seqs, dev, cell.config["control"] if control else None)
    numbers["errors"] = errors
    ok, checks = check.verdict(numbers, dict(cell.config["check"], errors=0))
    control_ok = check.control_verdict(numbers, cell.config["check"])
    print(f"reference: {json.dumps(numbers)} seconds {time.perf_counter() - t_ref:.1f}",
          file=log_to)

    result = {
        "correct": bool(ok),
        "attempted": len(stats.due_in_window(log)),
        "failed": stats.failed(log),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(mem_peak)},
    }
    if trace and run.trace:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace["device_ops"]],
                               "idle_gaps": [list(x) for x in run.trace["idle_gaps"]]}
    if control_ok is not None:
        result["control_correct"] = control_ok
    result["reference"] = numbers
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None)
    a = p.parse_args(argv)
    import torch

    from perfbench import spec as S

    cell = S.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and never the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    import mistral_inference_tpu_torch  # noqa: F401  (a checkout without the port fails here)

    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START,
                      control=bool(a.control), rate=a.rate)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the PyTorch port alone", file=sys.stderr)
        return 1
    if "control_correct" in result:
        print(f"control correct: {result['control_correct']} (has to be False)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
