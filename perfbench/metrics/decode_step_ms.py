"""Wall time of the window's steps less their admission time, over the
decode forwards (T = 1) they ran, in ms: the host-paced decode step."""

from perfbench import stats as S


def read(run: S.Run):
    steps = S.host_steps(run)
    n = sum(s.forwards["decode"] for s in steps)
    wall = sum(s.end - s.start - s.admission_s for s in steps)
    return 1e3 * wall / n if n else None
