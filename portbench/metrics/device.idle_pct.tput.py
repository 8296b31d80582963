"""Share of the traced sub-window with no kernel or copy on the device."""

from portbench.core import readers as R


def read(run):
    return R.idle_pct(run)
