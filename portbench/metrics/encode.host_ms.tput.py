"""Mean host ms a dispatch spends in its encode (the program's ``encode`` span: K1's launches and the eager encoder), over the window's dispatches."""

from portbench.core import spans as S


def read(run):
    return S.mean_ms_per(run, "asr.dispatch", ("encode",))
