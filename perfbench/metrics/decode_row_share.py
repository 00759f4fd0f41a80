"""The tokens that the decode blocks drained in the host span handed to
requests, over those blocks' B x n slots, in percent: the program's
``engine.drain`` spans. None where the program records no spans."""

from perfbench import stats as S


def read(run: S.Run):
    try:
        from mistral_inference_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    a, b = run.host_span
    drains = [s for s in spans() if s.name == "engine.drain" and s.end is not None
              and a <= s.start and s.end <= b]
    slots = sum(s.attrs["slots"] for s in drains)
    return 100.0 * sum(s.attrs["tokens"] for s in drains) / slots if slots else None
