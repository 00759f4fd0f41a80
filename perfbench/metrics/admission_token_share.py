"""The real prompt tokens that the engine's admission sweeps of the host
span prefilled, over the tokens they carried (rows x chunk width x chunks),
in percent: the program's ``engine.admit.sweep`` spans. None where the
program records no spans."""

from perfbench import stats as S


def read(run: S.Run):
    try:
        from mistral_inference_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    a, b = run.host_span
    sweeps = [s for s in spans() if s.name == "engine.admit.sweep" and s.end is not None
              and a <= s.start and s.end <= b]
    carried = sum(s.attrs["carried"] for s in sweeps)
    return 100.0 * sum(s.attrs["real"] for s in sweeps) / carried if carried else None
