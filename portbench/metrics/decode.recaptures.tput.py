"""CUDA-graph captures in the window of a loop shape captured before and evicted past ``MAX_GRAPHS`` (the decode loop's ``recaptures`` counter)."""

from portbench.core import spans as S


def read(run):
    return S.loop_counter_delta(run, "recaptures")
