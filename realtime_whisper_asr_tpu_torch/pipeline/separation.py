"""Vocal-separation frontends: isolate speech before ASR.

Port of ``realtime_whisper_asr_tpu/pipeline/separation.py`` (reference
`vocal_separation.py`: VocalSeparator base :18-44, DemucsSeparator :47-222,
SimpleFilterSeparator :303-372, factory :375-409):

- ``BandpassSeparator`` — the reference's shipped default (config
  ``method=filter``): an 85–3400 Hz zero-phase band-pass, on the device as
  one FFT convolution (``ops/dsp.py``), each chunk padded to a bucket;
  ``use_device=False`` keeps the JAX package's host brick-wall filter.
- ``NeuralSeparator`` (``models/separation_nn.py``) — the trained mask net.
- ``DemucsSeparator`` — an installed ``demucs`` package; without one the
  factory hands out the band-pass separator (the reference's rule for a
  missing package).

Deliberate difference: an error on the card propagates. The JAX separators
return the input unseparated on any exception; here only the length rules
(``n < 64`` for the band-pass, ``n < N_FFT`` for the net) pass audio
through.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.ops.dsp import bandpass_filter

logger = logging.getLogger(__name__)


def overlap_windowed(fn, x: np.ndarray, block: int, overlap: int = 4096) -> np.ndarray:
    """Apply ``fn`` (same-length audio→audio) in ``block``-sized windows with
    linearly crossfaded ``overlap`` regions, so every call stays inside a
    separator's bucket set; the crossfade hides the STFT edge effects at
    the joins."""
    n = len(x)
    step = block - overlap
    out = np.zeros(n, np.float32)
    acc = np.zeros(n, np.float32)
    ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
    for start in range(0, n, step):
        piece = np.asarray(fn(x[start : start + block]), np.float32)
        m = len(piece)
        w = np.ones(m, np.float32)
        if start > 0:
            w[: min(overlap, m)] = ramp[: min(overlap, m)]
        if start + m < n and m > overlap:
            w[-overlap:] *= ramp[::-1]
        out[start : start + m] += piece * w
        acc[start : start + m] += w
        if start + block >= n:
            break
    return out / np.maximum(acc, 1e-9)


class VocalSeparator:
    """Base: separate(chunk) -> vocals (same length/dtype)."""

    name = "none"

    def separate(self, audio: np.ndarray) -> np.ndarray:
        return audio

    def separate_stems(self, audio: np.ndarray) -> dict:
        """Two-stem split: {"vocals", "accompaniment"}, the accompaniment
        the time-domain complement ``mix − vocals``."""
        x = np.asarray(audio, np.float32)
        vocals = np.asarray(self.separate(x), np.float32)
        return {"vocals": vocals, "accompaniment": x - vocals}

    def get_stats(self) -> dict:
        return getattr(self, "stats", {})


class BandpassSeparator(VocalSeparator):
    name = "filter"

    def __init__(self, low_hz: float = 85.0, high_hz: float = 3400.0, use_device: bool = True,
                 device="cuda"):
        self.low_hz = low_hz
        self.high_hz = high_hz
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        self.stats = {"processed": 0, "errors": 0}
        #: the padded chunk lengths of the device path
        self._buckets = [1024, 4096, 16384, 65536, 262144, 1048576]

    @torch.inference_mode()
    def separate(self, audio: np.ndarray) -> np.ndarray:
        self.stats["processed"] += 1
        x = np.asarray(audio, np.float32)
        n = len(x)
        if n < 64:
            return audio
        if self.use_device:
            def one(seg: np.ndarray) -> np.ndarray:
                m = len(seg)
                nb = next(b for b in self._buckets if m <= b)
                padded = np.zeros(nb, np.float32)
                padded[:m] = seg
                y = bandpass_filter(torch.from_numpy(padded).to(self.device), self.low_hz,
                                    self.high_hz)
                return y.cpu().numpy()[:m]

            if n <= self._buckets[-1]:
                return one(x)
            return overlap_windowed(one, x, self._buckets[-1])
        # host path: frequency-domain brick-wall filter
        spec = np.fft.rfft(x)
        freqs = np.fft.rfftfreq(n, 1 / 16000)
        mask = ((freqs >= self.low_hz) & (freqs <= self.high_hz)).astype(np.float32)
        return np.fft.irfft(spec * mask, n).astype(np.float32)


class DemucsSeparator(VocalSeparator):
    """Neural separation via an installed demucs package. Optional."""

    name = "demucs"

    def __init__(self, model_name: str = "htdemucs", device="cuda"):
        self.stats = {"processed": 0, "errors": 0, "available": False}
        self._model = None
        try:
            from demucs.pretrained import get_model  # type: ignore

            model = get_model(model_name)
        except Exception:  # the package or its weights are not installed
            logger.warning("demucs unavailable")
            return
        self._device = resolve_device(device)
        self._model = model.to(self._device).eval()
        self.stats["available"] = True

    @staticmethod
    def _resample(x: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
        """Demucs models run at their own sample rate (htdemucs: 44100)."""
        from realtime_whisper_asr_tpu_torch.io.wav import resample_linear

        return resample_linear(np.asarray(x, np.float32), sr_from, sr_to)

    def _apply(self, audio: np.ndarray):
        """(stems tensor, model samplerate) at the MODEL's samplerate."""
        from demucs.apply import apply_model  # type: ignore

        sr_model = int(getattr(self._model, "samplerate", 44100))
        up = self._resample(np.asarray(audio, np.float32), 16000, sr_model)
        wav = torch.from_numpy(up)[None].repeat(2, 1)[None]
        with torch.no_grad():
            stems = apply_model(self._model, wav.to(self._device))[0]
        return stems, sr_model

    def _back(self, stem: np.ndarray, sr_model: int, n_out: int) -> np.ndarray:
        out = self._resample(stem, sr_model, 16000)
        if len(out) < n_out:
            out = np.pad(out, (0, n_out - len(out)))
        return out[:n_out]

    def separate(self, audio: np.ndarray) -> np.ndarray:
        self.stats["processed"] += 1
        if self._model is None:
            return audio
        stems, sr_model = self._apply(audio)
        vocals_idx = self._model.sources.index("vocals")
        return self._back(stems[vocals_idx].mean(0).cpu().numpy(), sr_model, len(audio))

    def separate_stems(self, audio: np.ndarray) -> dict:
        """All model stems by name, plus the summed non-vocal
        "accompaniment"."""
        if self._model is None:
            return super().separate_stems(audio)
        stems, sr_model = self._apply(audio)
        out = {
            name: self._back(stems[i].mean(0).cpu().numpy(), sr_model, len(audio))
            for i, name in enumerate(self._model.sources)
        }
        acc = sum(v for k, v in out.items() if k != "vocals")
        out["accompaniment"] = np.asarray(acc, np.float32)
        return out


def _pick(kw: dict, keys: tuple[str, ...]) -> dict:
    """Per-class kwarg filtering: callers (app.py) pass the whole config
    section; each separator takes only what it understands."""
    return {k: kw[k] for k in keys if k in kw}


def create_separator(method: Optional[str], **kw) -> Optional[VocalSeparator]:
    """Factory (reference vocal_separation.py:375-409): filter|demucs|neural|none.
    ``device`` (default the card) reaches every separator."""
    if method in (None, "", "none", False):
        return None
    if method == "filter":
        return BandpassSeparator(**_pick(kw, ("low_hz", "high_hz", "use_device", "device")))
    if method == "neural":
        from realtime_whisper_asr_tpu_torch.models.separation_nn import NeuralSeparator

        weights = kw.get("weights")
        if weights:
            return NeuralSeparator.load_npz(weights, **_pick(kw, ("use_device", "device")))
        return NeuralSeparator(**_pick(kw, ("params", "use_device", "variant", "device")))
    if method == "demucs":
        sep = DemucsSeparator(**_pick(kw, ("model_name", "device")))
        if not sep.stats["available"]:
            logger.warning("falling back to band-pass separator")
            return BandpassSeparator(**_pick(kw, ("device",)))
        return sep
    if method == "spleeter":
        # capability subsumed by the band-pass/demucs paths
        logger.warning("spleeter method maps to the band-pass separator here")
        return BandpassSeparator(**_pick(kw, ("low_hz", "high_hz", "use_device", "device")))
    raise ValueError(f"unknown separation method {method!r}")
