"""Decode attention (the ring write and the attention over each live row's
visible slots): least time over device time, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.trace_share(run, "attn_decode")
