"""The int8 products: the least time the window's int8 matmuls need (each
the larger of its operations at the int8 peak and its bytes at the memory's
bandwidth) over the device time of the kernels that carry them."""

from portbench.core import readers as R

#: the names of the kernels that carry the int8 products: cuBLASLt's int8
#: GEMMs behind ``torch._int_mm`` (on the H100 with torch 2.11 / CUDA 12.8:
#: ``cutlass_80_tensorop_i16832gemm_s8_*``)
KERNELS = (r"gemm_s8", r"s8s8", r"imma")


def read(run):
    return R.int8_mm_roofline(run, KERNELS)
