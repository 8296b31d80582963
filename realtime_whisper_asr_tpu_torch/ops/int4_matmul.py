"""Packed-int4 weight matmul: a hand-written CUDA kernel and its plain version.

``int4_matmul(xq, wp, s)`` is the entry point: (M, K) int8 activations times
nibble-packed int4 weights ``wp`` (K/2, N) int8 (``quant.pack_int4``'s
layout) with per-group f32 scales ``s`` (G, N) -> (M, N) f32 of
``sum_g s[g] * (xq_g · w4_g)``, the groups summed in order. The caller
applies its activation scale afterwards, as the JAX package's
``model._linear`` does.

On a CUDA tensor it launches the kernel of ``csrc/int4_matmul.cu`` (built
with ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) for every
M: there is no second device path for the same function. On a CPU tensor it
runs ``int4_matmul_plain``: unpack to int8, a per-group float64 matmul (f64
holds these integer sums exactly, on the CPU and in CUDA's DGEMM alike),
then the f32 scale and the in-order f32 sum over groups — the kernel's
arithmetic, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from realtime_whisper_asr_tpu_torch.models.whisper.quant import unpack_int4
from realtime_whisper_asr_tpu_torch.native.build import build_library

_CU_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "csrc", "int4_matmul.cu")

#: kernel launches since import (or since a caller reset it to 0), counted
#: only where the kernel is launched
int4_launches = 0


def _check(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or wp.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes int8 xq, int8 wp and f32 s, got {xq.dtype}, "
                        f"{wp.dtype}, {s.dtype}")
    if xq.dim() != 2 or wp.dim() != 2 or s.dim() != 2:
        raise ValueError("int4_matmul takes 2-D xq (M, K), wp (K/2, N), s (G, N)")
    if not (xq.is_contiguous() and wp.is_contiguous() and s.is_contiguous()):
        raise ValueError("int4_matmul takes contiguous tensors")
    m, k = xq.shape
    half, n = wp.shape
    g = s.shape[0]
    if k != 2 * half or s.shape[1] != n or g < 1 or half % g:
        raise ValueError(f"int4_matmul shapes do not match: xq {tuple(xq.shape)}, "
                         f"wp {tuple(wp.shape)}, s {tuple(s.shape)}")
    if not (xq.device == wp.device == s.device):
        raise ValueError("int4_matmul operands lie on different devices")


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
    lib.rtwa_int4_matmul.restype = ctypes.c_int
    lib.rtwa_int4_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rtwa_int4_error_string.restype = ctypes.c_char_p
    lib.rtwa_int4_error_string.argtypes = [ctypes.c_int]
    return lib


def build_kernel() -> str:
    """Build (or find up to date) the kernel library; returns its path."""
    return _lib()._name


def _int4_matmul_kernel(xq: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    global int4_launches
    m, k = xq.shape
    g, n = s.shape
    gs = k // g
    if n % 4 or k % 4 or gs % 32 or (gs > 128 and gs % 128):
        raise ValueError(f"int4 kernel takes N % 4 == 0 and groups of 32·j ≤ 128 or "
                         f"128·j input rows, got K={k}, N={n}, G={g}")
    if any(t.data_ptr() % 4 for t in (xq, wp, s)):
        raise ValueError("int4 kernel takes 4-byte aligned tensors")
    lib = _lib()
    y = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    rc = lib.rtwa_int4_matmul(
        xq.data_ptr(), wp.data_ptr(), s.data_ptr(), y.data_ptr(), m, k, n, g,
        xq.device.index or 0, torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"int4_matmul kernel launch failed: {lib.rtwa_int4_error_string(rc).decode()}")
    int4_launches += 1
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
