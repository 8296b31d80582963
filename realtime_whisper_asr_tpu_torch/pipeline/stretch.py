"""Speech-rate audio normalization (time-stretch) + adaptive decode params.

Port of ``realtime_whisper_asr_tpu/pipeline/stretch.py``. Capability parity
with `speech_rate_audio_processor.py`: fast/slow speech is time-stretched
toward normal (bounds 0.8–1.2, :83-96) before ASR by the phase vocoder of
``ops/dsp.py`` on ``device``, the phase carried across chunks, and decode
params adapt to measured rate (fast → larger beam, slightly higher
temperature, :214-237). An error on the card propagates (the JAX processor
returns the chunk unstretched).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.ops.dsp import time_stretch


class SpeechRateAudioProcessor:
    def __init__(self, min_rate: float = 0.8, max_rate: float = 1.2,
                 normal_cps: float = 10.0, min_samples: int = 4096, device="cuda"):
        self.min_rate = min_rate
        self.max_rate = max_rate
        self.normal_cps = normal_cps
        self.min_samples = min_samples
        self.device = resolve_device(device)
        self.stats = {"processed": 0, "stretched": 0, "errors": 0}
        #: the rate actually applied to the most recent chunk (1.0 =
        #: passthrough). Callers that measure speech rate from the
        #: processor's (stretched-timeline) timestamps must multiply result
        #: durations by this to recover RAW durations — otherwise the
        #: detector measures the vocoder's own output and the correction
        #: cancels itself into oscillation (app.process_chunk does this).
        self.applied_rate = 1.0
        #: carried synthesis phase ((n_fft//2+1,) f32) so consecutive chunks
        #: stay phase-continuous — independent per-chunk stretching restarts
        #: the vocoder phase at every boundary, a click per chunk. Reset when
        #: a chunk passes through unstretched (raw audio broke the synthetic
        #: timeline anyway).
        self._phase = None
        #: sub-min_samples accumulator: small session chunks (the CLI default
        #: read is 0.25 s = 4000 samples < min_samples) are held until a full
        #: block is available instead of silently passing through unstretched
        #: — which made the feature inert at default chunking and mixed raw
        #: and stretched audio in one timeline. Costs ≤min_samples/SR extra
        #: latency only while stretching is engaged.
        self._inbuf = np.zeros(0, np.float32)

    #: padded input lengths (the JAX package's bucket set: the zero tail
    #: enters the STFT, so the buckets are part of the result)
    _LEN_BUCKETS = (16000, 32000, 64000, 160000, 320000, 480000)

    def stretch_rate_for(self, measured_cps: Optional[float]) -> float:
        """NORMALIZING stretch: fast speech (measured > normal) gets rate<1
        (slowed down), slow speech rate>1 (sped up) — the reference's
        stretch = 1.0/rate_ratio (`speech_rate_audio_processor.py:79-96`;
        the previous measured/normal form AMPLIFIED the deviation). Bounded,
        and quantized to a 0.05 grid."""
        if not measured_cps or measured_cps <= 0:
            return 1.0
        rate = self.normal_cps / measured_cps
        rate = float(np.clip(rate, self.min_rate, self.max_rate))
        return round(round(rate / 0.05) * 0.05, 2)

    @torch.inference_mode()
    def process(self, audio: np.ndarray, measured_cps: Optional[float]) -> np.ndarray:
        """Normalize speech rate: the chunk stretched by ``stretch_rate_for``
        (held back while shorter than ``min_samples``), or passed through at
        a rate within 0.05 of 1."""
        self.stats["processed"] += 1
        audio = np.asarray(audio, np.float32)
        rate = self.stretch_rate_for(measured_cps)
        if abs(rate - 1.0) < 0.05:
            self.applied_rate = 1.0
            self._phase = None
            if len(self._inbuf):  # flush held audio unstretched, in order
                audio = np.concatenate([self._inbuf, audio])
                self._inbuf = np.zeros(0, np.float32)
            return audio
        if len(self._inbuf) + len(audio) < self.min_samples:
            self._inbuf = np.concatenate([self._inbuf, audio])
            self.applied_rate = 1.0  # nothing (re)timed was emitted this call
            return np.zeros(0, np.float32)
        if len(self._inbuf):
            audio = np.concatenate([self._inbuf, audio])
            self._inbuf = np.zeros(0, np.float32)
        n = len(audio)
        nb = next((b for b in self._LEN_BUCKETS if n <= b), None)
        if nb is None:  # beyond the largest bucket: pad to a coarse grid
            nb = -(-n // 160000) * 160000
        padded = np.zeros(nb, np.float32)
        padded[:n] = audio
        phase_in = (torch.zeros(513) if self._phase is None
                    else torch.from_numpy(self._phase)).to(self.device)
        # carry point = where the REAL content ends in the stretched
        # timeline (the zero-pad tail past it is dropped below)
        phase_at = (512 + int(n / rate)) // 256
        out, phase = time_stretch(torch.from_numpy(padded).to(self.device),
                                  float(round(rate, 2)), phase_in=phase_in,
                                  carry_phase=True, phase_at=phase_at)
        self._phase = phase.cpu().numpy()
        out = out[: int(n / rate)].cpu().numpy()  # drop the stretched zero-padding tail
        self.stats["stretched"] += 1
        self.applied_rate = rate
        return out


class AdaptiveWhisperParams:
    """Decode-param adaptation by speech rate (reference :170-253)."""

    def __init__(self, base_beam_size: int = 1, base_temperature: float = 0.0):
        self.base_beam_size = base_beam_size
        self.base_temperature = base_temperature

    def get_transcribe_kwargs(self, rate_class: str) -> dict:
        if rate_class == "fast":
            return {
                "beam_size": min(self.base_beam_size + 2, 8),
                "temperature": min(self.base_temperature + 0.1, 1.0),
            }
        if rate_class == "slow":
            return {"beam_size": self.base_beam_size, "temperature": self.base_temperature}
        return {"beam_size": self.base_beam_size, "temperature": self.base_temperature}
