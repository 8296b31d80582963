"""Mean host ms a dispatch waits in its decode loop's checks of the end (the program's ``decode.check`` spans, summed: where the host waits for the card), over the window's dispatches."""

from portbench.core import spans as S


def read(run):
    return S.mean_ms_per(run, "asr.dispatch", ("decode.check",))
