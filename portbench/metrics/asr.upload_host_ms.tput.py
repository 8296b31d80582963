"""Mean host ms a dispatch spends planning its window and uploading it (the program's ``asr.plan`` and ``asr.upload`` spans: the plan, the ring's copy and writes, the device draft's patch), over the window's dispatches."""

from portbench.core import spans as S


def read(run):
    return S.mean_ms_per(run, "asr.dispatch", ("asr.plan", "asr.upload"))
