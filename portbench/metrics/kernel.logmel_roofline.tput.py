"""K1, the log-mel kernel: the least time its launches need (the audio read
and the mel written once, at the memory's bandwidth) over its device time."""

from portbench.core import readers as R

#: the kernel's name in the trace
KERNELS = (r"\blogmel_kernel\b",)


def read(run):
    return R.logmel_roofline(run, KERNELS)
