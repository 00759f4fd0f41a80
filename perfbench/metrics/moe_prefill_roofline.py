"""The sorted ragged product (real rows only): least time over device
time, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.trace_share(run, "moe_prefill")
