"""Audio-dedup feature extraction on the device of the input.

Port of ``realtime_whisper_asr_tpu/ops/features.py``: the reference's 5-dim
feature vector per chunk — RMS, spectral centroid, zero-crossing rate, 85 %
roll-off, spectral bandwidth (`audio_deduplicator.py:60-181`) — for a batch
of chunks in one ``torch.fft`` pass, max-normalized. The similarities are
the JAX package's numpy functions, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.ops.dsp import cumsum_blocked

_EPS = 1e-10


def _rfftfreq(n: int, sampling_rate: int) -> np.ndarray:
    """f32 ``rfftfreq(n, 1 / sampling_rate)`` as the JAX package's f32
    program computes it: ``k / f32(n / sampling_rate)``."""
    k = np.arange(n // 2 + 1, dtype=np.float32)
    return k / np.float32((1.0 / sampling_rate) * n)


def dedup_features(chunks: torch.Tensor, sampling_rate: int = 16000,
                   n_valid=None) -> torch.Tensor:
    """(B, N) float32 audio chunks -> (B, 5) max-normalized feature vectors.

    ``n_valid`` marks the valid prefix when chunks are padded to a bucket
    length: RMS and ZCR normalize by the valid length; the spectral features
    see a zero-padded FFT (a finer interpolation of the same spectrum),
    which is consistent across same-bucket chunks — what the dedup gate
    compares. The roll-off is the first bin whose cumulative energy reaches
    0.85 of the total (``argmax`` of the comparison, as in the JAX package).
    """
    dev = chunks.device
    chunks = chunks.float()
    b, n = chunks.shape
    if n_valid is None:
        denom = torch.tensor(float(n), device=dev)
    else:
        denom = torch.clamp(torch.as_tensor(n_valid, device=dev), min=1).float()
    rms = torch.sqrt(torch.sum(chunks * chunks, dim=-1) / denom)

    spec = torch.fft.rfft(chunks, dim=-1).abs()
    freqs = torch.from_numpy(_rfftfreq(n, sampling_rate)).to(dev)
    total = torch.sum(spec, dim=-1) + _EPS
    centroid = torch.sum(spec * freqs[None, :], dim=-1) / total

    signs = torch.sign(chunks)
    zcr = torch.sum(torch.diff(signs, dim=-1).abs() > 0, dim=-1) / denom

    energy = spec * spec
    cum = cumsum_blocked(energy, dim=-1)
    target = 0.85 * cum[:, -1:]
    rolloff_idx = torch.argmax((cum >= target).to(torch.int32), dim=-1)
    rolloff = freqs[rolloff_idx]

    bandwidth = torch.sqrt(
        torch.sum(spec * torch.square(freqs[None, :] - centroid[:, None]), dim=-1) / total
    )

    feats = torch.stack([rms, centroid, zcr, rolloff, bandwidth], dim=-1)
    return feats / (torch.amax(feats.abs(), dim=-1, keepdim=True) + _EPS)


def cosine_similarity01(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity mapped to [0, 1] (reference audio_deduplicator.py:183-207).

    NOTE: saturates near 1.0 for ANY pair of all-positive feature vectors —
    kept for reference parity, but the dedup gate uses relative_similarity."""
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < _EPS or nb < _EPS:
        return 0.0
    return float((np.dot(a, b) / (na * nb) + 1.0) / 2.0)


def relative_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """1 − mean relative per-dimension difference, in [0, 1].

    Unlike cosine on all-positive vectors (which saturates ≥0.93 for ANY two
    audio chunks), this separates cleanly: exact duplicates → 1.0, distinct
    speech chunks → ≤~0.85, speech vs silence → ~0.5."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(1.0 - np.mean(np.abs(a - b) / (np.abs(a) + np.abs(b) + 1e-6)))
