"""Mean ms a tick's result sits in the async pipeline: from the end of its ``asr.dispatch`` span to the start of its ``asr.finalize``, over the window's ticks."""

from portbench.core import spans as S


def read(run):
    return S.hold_ms(run)
