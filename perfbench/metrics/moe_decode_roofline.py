"""The capacity dispatch (at most 256 rows): the bytes of the experts that
hold a live row and the routed rows' operations, least time over device
time, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.trace_share(run, "moe_decode")
