"""One less the union of the device's operation intervals over the traced
slice's wall time, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    t = run.trace or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
