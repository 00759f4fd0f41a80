"""Output tokens per second over the window: every token handed to a
client by the steps that overlap it, over the wall time those steps and the
window span together (``stats.output_rate``)."""

from perfbench import stats as S


def read(run: S.Run):
    return S.output_rate(run.log)
