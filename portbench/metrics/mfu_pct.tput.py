"""The window's model FLOPs (encoder, cross K/V, prefill, decode steps, head) over its wall time and the configuration's peak."""

from portbench.core import readers as R


def read(run):
    return R.mfu_pct(run)
