"""Mean host ms for an ASR dispatch call (batched, or one window) to return, in the window."""

from portbench.core import readers as R


def read(run):
    return R.dispatch_ms(run)
