"""Whisper log-mel frontend: a hand-written CUDA kernel and its plain version.

``log_mel_spectrogram(audio, n_mels)`` is the entry point. On a CUDA tensor
it launches the kernel of ``csrc/logmel.cu`` (built with ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes``): a real FFT in shared
memory (200-point complex FFT as 8 x 25, then the real split), fed by the
host-built tables of ``fft_tables`` and ``mel_table``. On a CPU tensor it
runs ``log_mel_spectrogram_plain``, the same function in plain torch f32
(reflect pad, unfold frames, two dense DFT matmuls, power, mel matmul,
log10). The plain version is the oracle the kernel is held against on the
card and what the CPU tests compare with the JAX package.

Both end with Whisper's normalisation as two torch ops: clamp to the global
max − 8 decades, then ``(x + 4) / 4``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.native.build import build_library
from realtime_whisper_asr_tpu_torch.ops import mel as melmod

N_FFT = 400
HOP_LENGTH = 160
_LOG_FLOOR = 1e-10
_CU_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "csrc", "logmel.cu")

#: kernel launches since import (or since a caller reset it to 0): counted
#: only where the kernel is launched, so a run can show its main path went
#: through the kernel and not the plain version
logmel_launches = 0


@functools.lru_cache(maxsize=8)
def _bases(device: torch.device, n_mels: int) -> tuple[torch.Tensor, ...]:
    """The plain version's dense bases (w·cos, w·(−sin), melT) as f32 tensors
    on ``device``: (400, 201), (400, 201), (201, n_mels). Built once per
    device and ``n_mels``."""
    w = melmod.hann_window(N_FFT)[:, None]
    cos_m, sin_m = melmod.dft_matrices(N_FFT)
    mel_t = melmod.mel_filterbank(n_mels, N_FFT).T
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (w * cos_m, w * sin_m, mel_t))


#: the kernel's table (``fft_table``): (name, length in floats) in order, as
#: the ``kTab*`` offsets of csrc/logmel.cu; complex entries are (re, im) pairs
FFT_TABLE_LAYOUT = (("window", 400), ("w8", 16), ("w200", 400), ("w5", 10), ("w25", 50),
                    ("w400", 402))


def _twiddles(j: np.ndarray, n: int) -> np.ndarray:
    """W_n^j = exp(−2πi·j/n) in float64 as (..., 2) (re, im) pairs, with the
    zeros at multiples of π/2 exact."""
    ang = 2.0 * np.pi * (np.asarray(j) % n) / n
    w = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    w[np.abs(w) < 1e-12] = 0.0
    return w


@functools.lru_cache(maxsize=1)
def fft_tables() -> dict[str, np.ndarray]:
    """The kernel's window and twiddles, built in float64 and rounded once to
    float32: ``window`` (400,), the periodic Hann window; ``w8`` (8, 2),
    W_8^j; ``w200`` (8, 25, 2), W_200^(k1·n2) at [k1, n2]; ``w5`` (5, 2),
    W_5^j; ``w25`` (5, 5, 2), W_25^(c·b) at [c, b]; ``w400`` (201, 2),
    W_400^k for k = 0..200."""
    k1, n2 = np.arange(8)[:, None], np.arange(25)[None, :]
    c, b = np.arange(5)[:, None], np.arange(5)[None, :]
    tables = {
        "window": melmod.hann_window(N_FFT),
        "w8": _twiddles(np.arange(8), 8),
        "w200": _twiddles(k1 * n2, 200),
        "w5": _twiddles(np.arange(5), 5),
        "w25": _twiddles(c * b, 25),
        "w400": _twiddles(np.arange(N_FFT // 2 + 1), N_FFT),
    }
    for name, a in tables.items():
        tables[name] = a.astype(np.float32)
        tables[name].flags.writeable = False
    return tables


def fft_table() -> np.ndarray:
    """``fft_tables`` flattened in ``FFT_TABLE_LAYOUT`` order, float32."""
    tables = fft_tables()
    return np.concatenate([tables[name].ravel() for name, _ in FFT_TABLE_LAYOUT])


@functools.lru_cache(maxsize=8)
def mel_table(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as the kernel reads it: (weights, index). ``weights``
    (float32) holds each filter's weights over its nonzero (triangular)
    support, filter by filter; ``index`` (int32, 2·n_mels + 1) holds each
    filter's first bin, then each filter's offset into ``weights`` and the
    total. Skipping the exact zeros outside the support leaves the sums equal
    to the dense ones."""
    fb = melmod.mel_filterbank(n_mels, N_FFT)
    nz = fb != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), fb.shape[1] - nz[:, ::-1].argmax(1), 0)
    weights = np.concatenate([fb[m, lo[m]:hi[m]] for m in range(n_mels)]).astype(np.float32)
    index = np.concatenate([lo, [0], np.cumsum(hi - lo)]).astype(np.int32)
    for a in (weights, index):
        a.flags.writeable = False
    return weights, index


@functools.lru_cache(maxsize=8)
def _kernel_tables(device: torch.device, n_mels: int) -> tuple[torch.Tensor, ...]:
    """(fft table, mel weights, mel index) on ``device``, uploaded once per
    device and ``n_mels``."""
    return tuple(torch.tensor(a, device=device) for a in (fft_table(), *mel_table(n_mels)))


def _check(audio: torch.Tensor) -> None:
    if audio.dtype != torch.float32:
        raise TypeError(f"log-mel takes float32 audio, got {audio.dtype}")
    if audio.dim() != 1 or not audio.is_contiguous():
        raise ValueError("log-mel takes one contiguous 1-D window")
    n = audio.shape[0]
    if n % HOP_LENGTH or n <= N_FFT // 2:
        raise ValueError(f"window length {n} must be a multiple of {HOP_LENGTH} "
                         f"and longer than {N_FFT // 2} samples")


def _normalize(log_spec: torch.Tensor) -> torch.Tensor:
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def _log10_mel_plain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    cosw, sinw, mel_t = _bases(audio.device, n_mels)
    pad = N_FFT // 2
    padded = torch.nn.functional.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    # centred STFT yields n//hop + 1 frames; Whisper drops the last one
    frames = padded.unfold(0, N_FFT, HOP_LENGTH)[: audio.shape[0] // HOP_LENGTH]
    re = frames @ cosw
    im = frames @ sinw
    mel = (re * re + im * im) @ mel_t
    return torch.log10(torch.clamp(mel, min=_LOG_FLOOR))


def log_mel_spectrogram_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Plain-torch Whisper log-mel, (len(audio) // 160, n_mels) float32, on
    the device the audio lies on."""
    _check(audio)
    return _normalize(_log10_mel_plain(audio, n_mels))


def _bind(path: str) -> ctypes.CDLL:
    """The kernel library at ``path``, with its C signatures declared."""
    lib = ctypes.CDLL(path)
    lib.rtwa_logmel.restype = ctypes.c_int
    lib.rtwa_logmel.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.rtwa_cuda_error_string.restype = ctypes.c_char_p
    lib.rtwa_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return _bind(build_library(
        "liblogmel.so", [_CU_SRC],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                     "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                     "-o", out, _CU_SRC],
    ))


def build_kernel() -> str:
    """Build (or find up to date) the kernel library; returns its path."""
    return _lib()._name


def _log10_mel_kernel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    global logmel_launches
    lib = _lib()
    tab, mel_w, mel_idx = _kernel_tables(audio.device, n_mels)
    out = torch.empty((audio.shape[0] // HOP_LENGTH, n_mels), dtype=torch.float32,
                      device=audio.device)
    rc = lib.rtwa_logmel(
        audio.data_ptr(), audio.shape[0], tab.data_ptr(), mel_w.data_ptr(), mel_idx.data_ptr(),
        n_mels, mel_w.shape[0], out.data_ptr(), audio.device.index or 0,
        torch.cuda.current_stream(audio.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"logmel kernel launch failed: {lib.rtwa_cuda_error_string(rc).decode()}")
    logmel_launches += 1
    return out


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel, (len(audio) // 160, n_mels) float32.

    A CUDA tensor goes through the hand-written kernel (a failed launch
    raises); a CPU tensor through the plain version. ``audio`` is one
    contiguous float32 window whose length is a multiple of 160 and longer
    than 200 samples (callers pad to the 8/16/30 s window buckets)."""
    _check(audio)
    if audio.device.type == "cuda":
        return _normalize(_log10_mel_kernel(audio, n_mels))
    if audio.device.type == "cpu":
        return _normalize(_log10_mel_plain(audio, n_mels))
    raise ValueError(f"log-mel runs on cuda or cpu tensors, not {audio.device}")
