"""90th percentile of time to first token, from when each request was due,
over every request due in the window; one unanswered at the drain cap
enters at the cap."""

from perfbench import stats as S


def read(run: S.Run):
    return S.percentile(S.ttfts(run.log), 0.9)
