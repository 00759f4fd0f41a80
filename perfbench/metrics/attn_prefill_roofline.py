"""Prefill attention (a chunk to the ring and to itself, and its ring
write): least time over device time, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.trace_share(run, "attn_prefill")
