"""Device ms of a dispatch's kernels outside its encode (the eager prefill and the replayed graphs), per new token served, over the dispatches wholly inside the trace."""

from portbench.core import readers as R


def read(run):
    return R.decode_ms_per_token(run)
