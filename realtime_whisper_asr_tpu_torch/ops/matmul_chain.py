"""Fused chain of bf16 matmuls: a hand-written CUDA kernel and its plain version.

``matmul_chain(x, ws)`` computes ``h <- bf16(h @ ws[i])`` for i = 0..k-1,
each product accumulated in f32 and rounded to bf16 before the next: the
function of the encoder microbenchmark's fused Pallas prototype
(``tools/microbench_encoder.py``), which the port's microbenchmark
(``tools/microbench_encoder.py`` in this package) times on the card.

On a CUDA tensor it launches the cooperative kernel of
``csrc/matmul_chain.cu`` (all k products in one launch, built with ``nvcc``
for ``sm_90a`` at first use, loaded with ``ctypes``); on a CPU tensor it runs
``matmul_chain_plain``: one f32 matmul and a bf16 rounding per step. The two
sum each product's f32 terms in another order, so an element may differ by
one bf16 rounding per step; ``chip_smoke.py`` states the tolerance.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from realtime_whisper_asr_tpu_torch.native.build import build_library

_CU_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "csrc", "matmul_chain.cu")
_BN = 128  # the kernel's output tile width

#: kernel launches since import (or since a caller reset it to 0), counted
#: only where the kernel is launched; one launch per chain
chain_launches = 0


def _check(x: torch.Tensor, ws: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or ws.dtype != torch.bfloat16:
        raise TypeError(f"matmul_chain takes bf16 x and ws, got {x.dtype}, {ws.dtype}")
    if x.dim() != 2 or ws.dim() != 3 or ws.shape[1:] != (x.shape[1], x.shape[1]):
        raise ValueError(f"matmul_chain takes x (T, D) and ws (k, D, D), got "
                         f"{tuple(x.shape)} and {tuple(ws.shape)}")
    if not (x.is_contiguous() and ws.is_contiguous()) or x.device != ws.device:
        raise ValueError("matmul_chain takes contiguous tensors on one device")


def matmul_chain_plain(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Plain torch version: one f32 product and bf16 rounding per step."""
    _check(x, ws)
    h = x
    for w in ws:
        h = (h.float() @ w.float()).to(torch.bfloat16)
    return h


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = build_library(
        "libmatmul_chain.so", [_CU_SRC],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                     "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                     "-o", out, _CU_SRC],
    )
    lib = ctypes.CDLL(path)
    lib.rtwa_matmul_chain.restype = ctypes.c_int
    lib.rtwa_matmul_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rtwa_chain_error_string.restype = ctypes.c_char_p
    lib.rtwa_chain_error_string.argtypes = [ctypes.c_int]
    return lib


def build_kernel() -> str:
    """Build (or find up to date) the kernel library; returns its path."""
    return _lib()._name


def _matmul_chain_kernel(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    global chain_launches
    t, d = x.shape
    k = ws.shape[0]
    if d % _BN or t < 1 or k < 1:
        raise ValueError(f"matmul_chain kernel takes D % {_BN} == 0, T ≥ 1 and k ≥ 1, "
                         f"got T={t}, D={d}, k={k}")
    if x.data_ptr() % 16 or ws.data_ptr() % 16:
        raise ValueError("matmul_chain kernel takes 16-byte aligned tensors")
    lib = _lib()
    out = torch.empty_like(x)
    scratch = torch.empty((2, t, d), dtype=x.dtype, device=x.device)
    rc = lib.rtwa_matmul_chain(
        x.data_ptr(), ws.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        out.data_ptr(), t, d, k, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"matmul_chain kernel launch failed: {lib.rtwa_chain_error_string(rc).decode()}")
    chain_launches += 1
    return out


def matmul_chain(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """bf16 x (T, D) through k products with ws (k, D, D) -> (T, D) bf16.
    A CUDA tensor goes through the hand-written kernel in one launch (a
    failed launch raises); a CPU tensor through the plain version."""
    _check(x, ws)
    if x.device.type == "cuda":
        return _matmul_chain_kernel(x, ws)
    if x.device.type == "cpu":
        return matmul_chain_plain(x, ws)
    raise ValueError(f"matmul_chain runs on cuda or cpu tensors, not {x.device}")
