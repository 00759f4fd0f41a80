"""The host's time enqueueing the decode blocks of the host span, over the
decode forwards they hold (the sum of their widths n), in ms: the program's
``engine.dispatch`` spans, the program's own part of ``decode_step_ms``.
None where the program records no spans."""

from perfbench import stats as S


def read(run: S.Run):
    try:
        from mistral_inference_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    a, b = run.host_span
    blocks = [s for s in spans() if s.name == "engine.dispatch" and s.end is not None
              and a <= s.start and s.end <= b]
    n = sum(s.attrs["n"] for s in blocks)
    return 1e3 * sum(s.end - s.start for s in blocks) / n if n else None
