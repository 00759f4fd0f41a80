"""The quantized linears called with more than 256 rows (real rows
counted): least time over device time, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.trace_share(run, "qlinear_prefill")
