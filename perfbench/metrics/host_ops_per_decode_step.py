"""Profiler CPU ops (aten) inside the traced slice's decode forwards, per
forward."""

from perfbench import stats as S


def read(run: S.Run):
    t = run.trace or {}
    n = t.get("decode_forwards", 0)
    return t["decode_host_ops"] / n if n else None
