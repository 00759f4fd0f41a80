"""The quantized linears called with at most 256 rows: least time of their
work over the device time they launched, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.trace_share(run, "qlinear_decode")
