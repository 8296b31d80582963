"""Mean host ms a finalize waits for its result's copy (the program's ``asr.fetch_wait`` span), over the window's finalizes."""

from portbench.core import spans as S


def read(run):
    return S.mean_ms_per(run, "asr.finalize", ("asr.fetch_wait",))
