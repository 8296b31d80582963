"""CUDA-graph captures of the decode loop inside the window (loop shapes past the ones the loop keeps)."""

from portbench.core import readers as R


def read(run):
    return R.captures(run)
