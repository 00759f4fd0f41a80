"""90th percentile, over the requests with tokens at two times or more in
the window, of each one's mean gap between output tokens, in ms."""

from perfbench import stats as S


def read(run: S.Run):
    v = S.percentile(S.tpots(run.log), 0.9)
    return None if v is None else 1e3 * v
