"""Model operations of the traced decode forwards over their device span
at the card's bf16 peak, in percent."""

from perfbench import stats as S


def read(run: S.Run):
    return S.mfu(run, "decode")
