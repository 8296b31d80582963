"""Mel filterbank / window / DFT-matrix construction (host-side, numpy).

Whisper's log-mel frontend uses an 80-bin (128 for large-v3) Slaney-style mel
filterbank over a 400-point STFT at 16 kHz with hop 160. The reference app gets
this from CTranslate2/librosa (SURVEY.md §2.3, reference asr_components.py:233);
here we build the matrices ourselves so the whole frontend can run on-device as
dot products with no audio-library dependency.

All functions are pure and cached; outputs are float32 numpy arrays that the
log-mel frontend (ops/logmel.py) uploads once per device.
"""

from __future__ import annotations

import functools

import numpy as np

SAMPLING_RATE = 16000


def _hz_to_mel_slaney(freq: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False): linear <1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 80,
    n_fft: int = 400,
    sampling_rate: int = SAMPLING_RATE,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2 + 1).

    Matches ``librosa.filters.mel(sr, n_fft, n_mels, htk=False, norm="slaney")``,
    which is what Whisper's official ``mel_filters.npz`` was generated with.
    """
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, n_freqs)

    mel_min = _hz_to_mel_slaney(fmin)
    mel_max = _hz_to_mel_slaney(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def hann_window(n_fft: int = 400) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window(periodic=True))."""
    n = np.arange(n_fft, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int = 400) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis matrices (cos, -sin), each shape (n_fft, n_fft//2 + 1).

    ``frames @ cos`` and ``frames @ sin`` give the real/imag parts of
    ``rfft(frames)``, turning the STFT into two matmuls.
    """
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
