"""Packed-int4 linear: a hand-written CUDA kernel family and its plain version.

Two entry points over nibble-packed int4 weights ``wp`` (K/2, N) int8
(``quant.pack_int4``'s layout) with per-group f32 scales ``s`` (G, N):

- ``int4_matmul(xq, wp, s)``: (M, K) int8 activations -> (M, N) f32 of
  ``sum_g s[g] * (xq_g · w4_g)``, the groups summed in order;
- ``int4_linear(x, wp, s, bias)``: the whole int4 branch of the JAX
  package's ``model._linear``: x (M, K) in f32 or bf16 quantized per row
  (``int8_matmul.quantize_rows``), the product above, ``* sx``, cast to x's
  dtype, then ``+ bias`` in that dtype.

On a CUDA tensor each launches the kernels of ``csrc/int4_matmul.cu`` (built
with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``):
``int4_matmul`` one launch at every M; ``int4_linear`` one launch for
M ≤ ``DECODE_MAX_M`` (a block per 32 columns, the quantization and the
epilogue fused) and two above (a row-quantization pass, then the
tensor-core product with the epilogue). The library checks the shapes the
kernels take and refuses any other (a ``RuntimeError`` here). There is no
second device path for either function. On a CPU
tensor they run ``int4_matmul_plain`` / ``int4_linear_plain``: unpack to
int8, a per-group float64 matmul (f64 holds these integer sums exactly, on
the CPU and in CUDA's DGEMM alike), then the f32 scale and the in-order f32
sum over groups, and for the linear the same quantization and epilogue —
the kernels' arithmetic, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from realtime_whisper_asr_tpu_torch.models.whisper.quant import unpack_int4
from realtime_whisper_asr_tpu_torch.native.build import build_library
from realtime_whisper_asr_tpu_torch.ops.int8_matmul import quantize_rows

_CU_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "csrc", "int4_matmul.cu")

#: rows up to which a product runs on the decode kernel, quantization and
#: epilogue fused (the kernel's kDecodeMaxM); ``int4_linear`` takes two
#: launches above it
DECODE_MAX_M = 8

#: kernel launches since import (or since a caller reset it to 0), counted
#: only where the kernels are launched: one per launch, both entry points
int4_launches = 0


def _check(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or wp.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes int8 xq, int8 wp and f32 s, got {xq.dtype}, "
                        f"{wp.dtype}, {s.dtype}")
    _check_shapes("int4_matmul", xq, wp, s)


def _check_shapes(name: str, x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> None:
    if x.dim() != 2 or wp.dim() != 2 or s.dim() != 2:
        raise ValueError(f"{name} takes 2-D x (M, K), wp (K/2, N), s (G, N)")
    if not (x.is_contiguous() and wp.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    k = x.shape[1]
    half, n = wp.shape
    g = s.shape[0]
    if k != 2 * half or s.shape[1] != n or g < 1 or half % g:
        raise ValueError(f"{name} shapes do not match: x {tuple(x.shape)}, "
                         f"wp {tuple(wp.shape)}, s {tuple(s.shape)}")
    if not (x.device == wp.device == s.device):
        raise ValueError(f"{name} operands lie on different devices")


def _check_linear(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                  bias: torch.Tensor | None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or wp.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise TypeError(f"int4_linear takes f32 or bf16 x, int8 wp and f32 s, got {x.dtype}, "
                        f"{wp.dtype}, {s.dtype}")
    _check_shapes("int4_linear", x, wp, s)
    if bias is not None:
        if bias.dtype != x.dtype:
            raise TypeError(f"int4_linear takes a bias of x's dtype {x.dtype}, got {bias.dtype}")
        if bias.shape != (wp.shape[1],) or not bias.is_contiguous() or bias.device != x.device:
            raise ValueError(f"int4_linear takes a contiguous bias (N,) = ({wp.shape[1]},) on "
                             f"x's device, got {tuple(bias.shape)} on {bias.device}")


def int4_matmul_plain(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain torch version, exact on both devices (see the module note)."""
    _check(xq, wp, s)
    m, k = xq.shape
    g, n = s.shape
    w = unpack_int4(wp).double().view(g, k // g, n)
    x = xq.double().view(m, g, k // g).transpose(0, 1)
    parts = torch.bmm(x, w).float() * s[:, None, :]  # (G, M, N), exact sums
    y = parts[0]
    for i in range(1, g):
        y = y + parts[i]
    return y


def int4_linear_plain(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of ``int4_linear``: ``quantize_rows``, the plain
    product, ``* sx``, the cast to x's dtype, then ``+ bias``."""
    _check_linear(x, wp, s, bias)
    xq, sx = quantize_rows(x)
    y = (int4_matmul_plain(xq, wp, s) * sx).to(x.dtype)
    return y if bias is None else y + bias


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = build_library(
        "libint4_matmul.so", [_CU_SRC],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                     "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                     "-o", out, _CU_SRC],
    )
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtwa_int4_matmul.restype = i
    lib.rtwa_int4_matmul.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.rtwa_int4_linear.restype = i
    lib.rtwa_int4_linear.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.rtwa_int4_error_string.restype = ctypes.c_char_p
    lib.rtwa_int4_error_string.argtypes = [i]
    return lib


def build_kernel() -> str:
    """Build (or find up to date) the kernel library; returns its path."""
    return _lib()._name


def _launch(x: torch.Tensor, linear: bool):
    """(library, workspace, device index, stream, launches) for a launch at
    x's rows. The kernels' shape limits are checked by the library itself
    (``shape_ok`` in the source), which refuses a shape it cannot take."""
    m, k = x.shape
    index = x.get_device()
    work, launches = None, 1
    if m > DECODE_MAX_M and linear:  # quantized rows, then their scales
        work = torch.empty(-(-m * k // 16) * 16 + 4 * m, dtype=torch.int8, device=x.device)
        launches = 2
    return _lib(), work, index, torch._C._cuda_getCurrentRawStream(index), launches


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _raise(lib: ctypes.CDLL, name: str, rc: int, x: torch.Tensor, s: torch.Tensor):
    m, k = x.shape
    g, n = s.shape
    raise RuntimeError(
        f"{name} kernel refused or failed at M={m}, K={k}, N={n}, G={g} (the shapes it takes: "
        f"shape_ok in csrc/int4_matmul.cu): {lib.rtwa_int4_error_string(rc).decode()}")


def _int4_matmul_kernel(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    global int4_launches
    lib, _, index, stream, launches = _launch(xq, linear=False)
    m, k = xq.shape
    g, n = s.shape
    y = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    rc = lib.rtwa_int4_matmul(xq.data_ptr(), wp.data_ptr(), s.data_ptr(), y.data_ptr(),
                              m, k, n, g, index, stream)
    if rc != 0:
        _raise(lib, "int4_matmul", rc, xq, s)
    int4_launches += launches
    return y


def _int4_linear_kernel(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                        bias: torch.Tensor | None) -> torch.Tensor:
    global int4_launches
    lib, work, index, stream, launches = _launch(x, linear=True)
    m, k = x.shape
    g, n = s.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.rtwa_int4_linear(x.data_ptr(), x.dtype == torch.bfloat16, wp.data_ptr(),
                              s.data_ptr(), _ptr(bias), y.data_ptr(), _ptr(work),
                              m, k, n, g, index, stream)
    if rc != 0:
        _raise(lib, "int4_linear", rc, x, s)
    int4_launches += launches
    return y


def int4_matmul(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × packed (K/2, N) int4 with (G, N) f32 group scales ->
    (M, N) f32. A CUDA tensor goes through the hand-written kernel (a failed
    launch raises); a CPU tensor through the plain version."""
    _check(xq, wp, s)
    if xq.device.type == "cuda":
        return _int4_matmul_kernel(xq, wp, s)
    if xq.device.type == "cpu":
        return int4_matmul_plain(xq, wp, s)
    raise ValueError(f"int4_matmul runs on cuda or cpu tensors, not {xq.device}")


def int4_linear(x: torch.Tensor, wp: torch.Tensor, s: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """f32 or bf16 x (M, K) through the packed-int4 weight, with an optional
    bias (N,) of x's dtype -> (M, N) in x's dtype: the JAX package's int4
    ``_linear``. A CUDA tensor goes through the hand-written kernels (one
    launch for M ≤ ``DECODE_MAX_M``, two above; a failed launch raises); a
    CPU tensor through the plain version."""
    _check_linear(x, wp, s, bias)
    if x.device.type == "cuda":
        return _int4_linear_kernel(x, wp, s, bias)
    if x.device.type == "cpu":
        return int4_linear_plain(x, wp, s, bias)
    raise ValueError(f"int4_linear runs on cuda or cpu tensors, not {x.device}")
