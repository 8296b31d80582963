"""Adaptive-noise-floor energy VAD (host, deterministic, weight-free).

Replaces the role Silero VAD plays in the reference (`asr_components.py:96`,
`enhanced_asr_processor.py:439`) for environments without trained weights
(this framework assumes zero network access). Works on 512-sample frames at
16 kHz like Silero; produces a speech probability in [0, 1] compatible with
the VADIterator threshold semantics (threshold / threshold−0.15 hysteresis).

Algorithm: per-frame log energy vs an adaptive noise floor (fast to fall onto
silence, slow to rise through speech), plus a spectral-tilt term that favors
the 300–3400 Hz speech band. Deterministic given the input stream → the VAC
state machine is unit-testable with synthetic audio.
"""

from __future__ import annotations

import numpy as np

FRAME = 512
_EPS = 1e-10


class EnergyVAD:
    def __init__(
        self,
        snr_threshold_db: float = 8.0,
        softness_db: float = 3.0,
        floor_rise_db_per_frame: float = 0.08,
        floor_init_db: float = -65.0,
        band_weight: float = 0.3,
        sampling_rate: int = 16000,
    ):
        self.snr_threshold_db = snr_threshold_db
        self.softness_db = softness_db
        self.floor_rise = floor_rise_db_per_frame
        self.floor_init_db = floor_init_db
        self.band_weight = band_weight
        # precompute speech-band mask for a 512-point rFFT at 16 kHz
        freqs = np.fft.rfftfreq(FRAME, 1.0 / sampling_rate)
        self._band = ((freqs >= 300) & (freqs <= 3400)).astype(np.float32)
        self.reset()

    def reset(self):
        self.noise_floor_db = self.floor_init_db

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """frames: (N, 512) float32 -> (N,) speech probabilities (stateful)."""
        frames = np.asarray(frames, np.float32)
        probs = np.empty(frames.shape[0], np.float32)
        for i, frame in enumerate(frames):
            energy_db = 10.0 * np.log10(float(np.mean(frame * frame)) + _EPS)
            if energy_db < self.noise_floor_db:
                self.noise_floor_db = energy_db  # fast fall
            else:
                self.noise_floor_db += self.floor_rise  # slow rise
            snr_db = energy_db - self.noise_floor_db
            spec = np.abs(np.fft.rfft(frame))
            total = float(spec.sum()) + _EPS
            band_ratio = float((spec * self._band).sum()) / total  # ~0.2 noise, ~0.7 speech
            score = (snr_db - self.snr_threshold_db) / self.softness_db
            score += self.band_weight * (band_ratio - 0.35) * 10.0
            probs[i] = 1.0 / (1.0 + np.exp(-score))
        return probs
