"""Process start to the window's start: the kernel build on a first run,
the weights, the warm-up and the traffic's ramp."""

from perfbench import stats as S


def read(run: S.Run):
    return run.setup_s
