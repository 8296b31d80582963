"""Audio-level dedup gate: drop chunks acoustically similar to recent ones.

Port of ``realtime_whisper_asr_tpu/pipeline/dedup_audio.py``. Capability parity with the reference AudioDeduplicator
(`audio_deduplicator.py:20-316`): a 5-dim spectral feature vector per chunk
compared against a bounded history, with the "duplicate" vs "similar"
threshold distinction. The comparison uses relative per-dimension similarity
instead of the reference's shifted cosine — cosine between all-positive
feature vectors saturates ≥0.93 for ANY two audio chunks, which makes the
gate either dead or all-consuming (measured; see ops.features). The feature
vector is computed on the host in numpy by default, as in the JAX package,
or with ``use_device=True`` on ``device`` as one ``ops.features`` pass over
the chunk padded to a bucket. An error in the features propagates (the JAX
gate counts it and never skips).

Saves the model compute: a skipped chunk never reaches VAD/ASR
(call site parity: reference 一键实时识别麦克风.py:1486-1500).
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.ops.features import dedup_features, relative_similarity


def _features_numpy(chunk: np.ndarray, sampling_rate: int = 16000) -> np.ndarray:
    """Host fallback, numerically equivalent to ops.features.dedup_features."""
    x = np.asarray(chunk, np.float32)
    rms = float(np.sqrt(np.mean(x * x)))
    spec = np.abs(np.fft.rfft(x))
    freqs = np.fft.rfftfreq(len(x), 1.0 / sampling_rate)
    total = spec.sum() + 1e-10
    centroid = float((spec * freqs).sum() / total)
    zcr = float(np.mean(np.abs(np.diff(np.sign(x))) > 0))
    energy = spec * spec
    cum = np.cumsum(energy)
    rolloff = float(freqs[int(np.argmax(cum >= 0.85 * cum[-1]))])
    bandwidth = float(np.sqrt((spec * (freqs - centroid) ** 2).sum() / total))
    f = np.array([rms, centroid, zcr, rolloff, bandwidth], np.float32)
    return f / (np.max(np.abs(f)) + 1e-10)


class AudioDeduplicator:
    def __init__(
        self,
        similarity_threshold: float = 0.98,
        duplicate_threshold: float = 0.995,
        time_window_s: float = 5.0,
        history_size: int = 100,
        min_chunk_samples: int = 256,
        use_device: bool = False,
        clock: Callable[[], float] = _time.time,
        device="cuda",
    ):
        self.similarity_threshold = similarity_threshold
        self.duplicate_threshold = duplicate_threshold
        self.time_window_s = time_window_s
        self.history: deque[tuple[float, np.ndarray]] = deque(maxlen=history_size)
        self.min_chunk_samples = min_chunk_samples
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        self.clock = clock
        self.stats = {"total": 0, "skipped": 0, "duplicates": 0, "similar": 0, "errors": 0}

    #: device-path bucket lengths (the JAX package's)
    _BUCKETS = (4096, 16384, 65536)

    @torch.inference_mode()
    def extract_features(self, chunk: np.ndarray) -> np.ndarray:
        if self.use_device:
            n = len(chunk)
            nb = next((b for b in self._BUCKETS if n <= b), self._BUCKETS[-1])
            padded = np.zeros(nb, np.float32)
            padded[:n] = np.asarray(chunk[:nb], np.float32)
            feats = dedup_features(torch.from_numpy(padded).to(self.device)[None],
                                   n_valid=min(n, nb))
            return feats.reshape(-1).cpu().numpy()
        return _features_numpy(chunk)

    def should_skip(self, chunk: np.ndarray, current_time: Optional[float] = None) -> tuple[bool, str]:
        now = self.clock() if current_time is None else current_time
        self.stats["total"] += 1
        if len(chunk) < self.min_chunk_samples:
            return False, "too_short_to_judge"
        feats = self.extract_features(chunk)

        best = 0.0
        for ts, h in self.history:
            if now - ts > self.time_window_s:
                continue
            sim = relative_similarity(feats, h)
            best = max(best, sim)
            if sim >= self.duplicate_threshold:
                self.stats["skipped"] += 1
                self.stats["duplicates"] += 1
                return True, f"duplicate({sim:.3f})"
        if best >= self.similarity_threshold:
            self.stats["skipped"] += 1
            self.stats["similar"] += 1
            self.history.append((now, feats))
            return True, f"similar({best:.3f})"

        self.history.append((now, feats))
        return False, "unique"

    def get_stats(self) -> dict:
        out = dict(self.stats)
        out["skip_rate"] = out["skipped"] / out["total"] if out["total"] else 0.0
        return out

    def reset(self):
        self.history.clear()
        for k in self.stats:
            self.stats[k] = 0
