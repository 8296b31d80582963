"""Microphone capture and simulated feeds.

``MicrophoneStream`` wraps sounddevice/PortAudio when available (the thin host
I/O edge, reference `一键实时识别麦克风.py:2155-2162`); where sounddevice
is absent, ``SimulatedMicStream`` provides the same blocking
``read(n) -> (np.ndarray, overflowed)`` interface from a WAV file or array,
optionally paced to wall-clock realtime (benchmark mode runs unpaced).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

SR = 16000


def _sounddevice():
    try:
        import sounddevice as sd  # type: ignore

        return sd
    except Exception:
        return None


def list_audio_devices() -> list[dict]:
    """Input devices (reference 一键…py:1182-1201); empty without PortAudio."""
    sd = _sounddevice()
    if sd is None:
        return []
    out = []
    for i, dev in enumerate(sd.query_devices()):
        if dev.get("max_input_channels", 0) > 0:
            out.append({"index": i, "name": dev["name"],
                        "channels": dev["max_input_channels"],
                        "default_samplerate": dev.get("default_samplerate")})
    return out


class MicrophoneStream:
    """Blocking PortAudio input stream (gated on sounddevice availability)."""

    def __init__(self, device: Optional[int] = None, samplerate: int = SR,
                 blocksize: int = 0):
        sd = _sounddevice()
        if sd is None:
            raise RuntimeError(
                "sounddevice/PortAudio not available in this environment; "
                "use SimulatedMicStream or install sounddevice"
            )
        self._stream = sd.InputStream(
            device=device, channels=1, samplerate=samplerate, dtype="float32",
            blocksize=blocksize,
        )
        self._stream.start()
        self.closed = False

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        data, overflowed = self._stream.read(n)
        return data[:, 0].copy(), bool(overflowed)

    def close(self):
        if not self.closed:
            self._stream.stop()
            self._stream.close()
            self.closed = True


class SimulatedMicStream:
    """Deterministic mic: serves a fixed array; optional realtime pacing.

    ``read`` past the end returns zeros (open-mic silence) until ``exhausted``
    is checked by the caller, matching how a real mic never 'ends'.
    """

    def __init__(self, audio: np.ndarray, samplerate: int = SR, realtime: bool = False,
                 fail_at_reads: Optional[set[int]] = None):
        self.audio = np.asarray(audio, np.float32)
        self.samplerate = samplerate
        self.realtime = realtime
        self.pos = 0
        self.reads = 0
        self.closed = False
        self.fail_at_reads = fail_at_reads or set()
        self._t0: Optional[float] = None

    @classmethod
    def from_wav(cls, path: str, **kw) -> "SimulatedMicStream":
        from realtime_whisper_asr_tpu_torch.io.wav import read_wav

        return cls(read_wav(path), **kw)

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.audio)

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        if self.closed:
            raise RuntimeError("stream is closed")
        self.reads += 1
        if self.reads in self.fail_at_reads:
            raise OSError("simulated device failure (unplugged)")
        if self.realtime:
            if self._t0 is None:
                self._t0 = time.monotonic()
            target = self.pos / self.samplerate
            sleep = self._t0 + target + n / self.samplerate - time.monotonic()
            if sleep > 0:
                time.sleep(sleep)
        chunk = self.audio[self.pos : self.pos + n]
        self.pos += n
        if len(chunk) < n:
            chunk = np.pad(chunk, (0, n - len(chunk)))
        return chunk, False

    def close(self):
        self.closed = True

    def reopen(self):
        """Simulated 'replug': resume serving from the current position."""
        self.closed = False
