"""The engine's admission timer (``admission_prefill_s``) over the wall time
of the window (less a traced run's profiled slice), in percent: where the
open-loop cell's TTFT goes."""

from perfbench import stats as S


def read(run: S.Run):
    return S.admission_share(run)
