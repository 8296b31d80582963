"""WAV read/write via the stdlib (no soundfile/librosa in this image).

Reads 8/16/32-bit PCM and 32-bit float WAVs, downmixes to mono, resamples to
16 kHz (linear interpolation) — sufficient for the benchmark feeds and offline
transcription examples (reference `先看这个，cursor不用看/1.py,2.py` analogs).
"""

from __future__ import annotations

import wave

import numpy as np

SR = 16000


def _read_float_wav(path: str):
    """Minimal RIFF parse for WAVE_FORMAT_IEEE_FLOAT (format tag 3), which
    the stdlib ``wave`` module rejects ('unknown format: 3') — yet float32 is
    the default output of soundfile/librosa, so these files are common."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        n_channels = sr = bits = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid = head[:4]
            size = int.from_bytes(head[4:8], "little")
            chunk = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                tag = int.from_bytes(chunk[0:2], "little")
                if tag not in (3, 0xFFFE):  # float or extensible
                    raise ValueError(f"not a float WAV (format {tag})")
                n_channels = int.from_bytes(chunk[2:4], "little")
                sr = int.from_bytes(chunk[4:8], "little")
                bits = int.from_bytes(chunk[14:16], "little")
            elif cid == b"data":
                data = chunk
        if data is None or sr is None:
            raise ValueError("missing fmt/data chunk")
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dt).astype(np.float32)
        return x, n_channels, sr


def read_wav(path: str, target_sr: int = SR) -> np.ndarray:
    """-> float32 mono in [-1, 1] at target_sr."""
    try:
        with wave.open(path, "rb") as w:
            n_channels = w.getnchannels()
            width = w.getsampwidth()
            sr = w.getframerate()
            raw = w.readframes(w.getnframes())
    except wave.Error as e:
        if "unknown format: 3" not in str(e):
            raise
        x, n_channels, sr = _read_float_wav(path)  # IEEE-float WAV
        width = None
    if width is None:
        pass  # already float samples in [-1, 1]
    elif width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        xi = np.frombuffer(raw, np.int32)
        # via `wave` a width-4 file is int32 PCM (float files take the
        # format-3 path above and never reach here)
        x = xi.astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    if sr != target_sr:
        x = resample_linear(x, sr, target_sr)
    return x.astype(np.float32)


def resample_linear(x: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Linear-interpolation resample — adequate for the ≤8 kHz speech band
    (shared by read_wav and DemucsSeparator's 16 kHz↔model-rate hops)."""
    if sr_from == sr_to or len(x) == 0:
        return np.asarray(x, np.float32)
    n_out = int(round(len(x) * sr_to / sr_from))
    return np.interp(
        np.linspace(0.0, len(x) - 1.0, n_out), np.arange(len(x)), x
    ).astype(np.float32)


def write_wav(path: str, audio: np.ndarray, sr: int = SR) -> None:
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
