"""Nearest-rank 90th percentile, over the requests submitted in the host
span, of each one's wait in the engine's queue: the program's
``request.queued`` span, from its submit to the start of the sweep that
took it. One never taken waits until the drain's end. None where the program
records no spans."""

from perfbench import stats as S


def read(run: S.Run):
    try:
        from mistral_inference_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    a, b = run.host_span
    waits = [(run.log.end if s.end is None else s.end) - s.start
             for s in spans() if s.name == "request.queued" and a <= s.start < b]
    return S.percentile(waits, 0.9)
