"""Device ms of the kernels launched inside the ASR's encode, per row encoded, over the dispatches wholly inside the trace."""

from portbench.core import readers as R


def read(run):
    return R.encode_ms_per_row(run)
