"""Mean host ms a dispatch spends in its eager prefill (the program's ``decode.prefill`` span), over the window's dispatches."""

from portbench.core import spans as S


def read(run):
    return S.mean_ms_per(run, "asr.dispatch", ("decode.prefill",))
