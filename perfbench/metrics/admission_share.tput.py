"""The engine's admission timer over the window's wall time, in percent,
in a cell judged by its output tokens per second."""

from perfbench import stats as S


def read(run: S.Run):
    return S.admission_share(run)
