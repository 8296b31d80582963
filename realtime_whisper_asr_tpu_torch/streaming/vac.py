"""VAD-controlled streaming: VADIterator state machine + VAC online processor.

Re-provides the Silero VADIterator/FixedVADIterator contract the reference
consumes (SURVEY.md §2.2; dynamic ``min_silence_samples`` mutation at
`asr_components.py:36-51`; arbitrary-length buffering at :58-78) and the
VACOnlineASRProcessor routing semantics (`asr_components.py:81-179`):

- voice start → ``online.init(offset=start_time)`` and forward buffered audio,
- voice end → mark current utterance final,
- ``process_iter``: finish() when final; process when ≥ online_chunk_size
  buffered; else (None, None, "").

The probability model is pluggable (``prob_fn: (frames (N,512)) -> (N,)``):
the DSP energy VAD (models/vad/energy.py, host) or the Silero-like LSTM VAD
(models/vad/silero_like.py, torch, on the card by default) both fit.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

from realtime_whisper_asr_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

SAMPLING_RATE = 16000
FRAME = 512  # samples per VAD window (Silero convention at 16 kHz)


class VADIterator:
    """Streaming speech start/end detector over 512-sample frames.

    Accepts arbitrary-length float32 chunks (internally re-framed), returns
    ``{'start': sample_idx}`` / ``{'end': sample_idx}`` events in absolute
    samples. ``min_silence_samples`` is mutable at runtime — the dynamic
    silence adaptation path (reference `asr_components.py:49`,
    `一键实时识别麦克风.py:1614-1644`) writes it directly or via
    ``set_min_silence_duration_ms``.
    """

    def __init__(
        self,
        prob_fn: Callable[[np.ndarray], np.ndarray],
        threshold: float = 0.5,
        sampling_rate: int = SAMPLING_RATE,
        min_silence_duration_ms: int = 500,
        speech_pad_ms: int = 100,
    ):
        self.prob_fn = prob_fn
        self.threshold = threshold
        self.sampling_rate = sampling_rate
        self.min_silence_samples = sampling_rate * min_silence_duration_ms / 1000
        self.speech_pad_samples = sampling_rate * speech_pad_ms / 1000
        self.reset_states()

    def reset_states(self):
        self.triggered = False
        self.temp_end = 0
        self.current_sample = 0
        self.buffer = np.array([], dtype=np.float32)

    def set_min_silence_duration_ms(self, ms: float) -> None:
        self.min_silence_samples = self.sampling_rate * ms / 1000

    def __call__(self, chunk: np.ndarray) -> list[dict]:
        """Feed a chunk; returns the ordered list of events it produced.

        A single chunk can legitimately contain an utterance end AND the next
        utterance's start (or a whole short utterance); returning them in
        order lets the consumer handle each transition correctly instead of
        collapsing them into one ambiguous dict.
        """
        self.buffer = np.append(self.buffer, np.asarray(chunk, np.float32))
        events: list[dict] = []
        while len(self.buffer) >= FRAME:
            frame = self.buffer[:FRAME]
            self.buffer = self.buffer[FRAME:]
            ev = self._process_frame(frame)
            if ev is not None:
                events.append(ev)
        return events

    def _process_frame(self, frame: np.ndarray) -> Optional[dict]:
        prob = float(self.prob_fn(frame[None, :])[0])
        self.current_sample += FRAME
        if prob >= self.threshold:
            if self.temp_end:
                self.temp_end = 0
            if not self.triggered:
                self.triggered = True
                start = int(self.current_sample - FRAME - self.speech_pad_samples)
                return {"start": max(start, 0)}
            return None
        if prob < self.threshold - 0.15 and self.triggered:
            if not self.temp_end:
                self.temp_end = self.current_sample
            if self.current_sample - self.temp_end >= self.min_silence_samples:
                end = int(self.temp_end + self.speech_pad_samples)
                self.temp_end = 0
                self.triggered = False
                return {"end": end}
        return None


class VACOnlineASRProcessor:
    """VAD-gated wrapper around OnlineASRProcessor (the reference's preferred
    EnhancedVACOnlineASRProcessor path, `enhanced_asr_processor.py:401-503`)."""

    SAMPLING_RATE = SAMPLING_RATE

    def __init__(
        self,
        online,  # OnlineASRProcessor
        vad_iterator: VADIterator,
        online_chunk_size: float = 0.5,
    ):
        self.online = online
        self.vac = vad_iterator
        self.online_chunk_size = online_chunk_size
        self.init()

    def init(self, offset: Optional[float] = None):
        self.online.init(offset)
        self.vac.reset_states()
        self.current_online_chunk_buffer_size = 0
        self.is_currently_final = False
        self.status: Optional[str] = None  # 'voice' | 'nonvoice'
        self.audio_buffer = np.array([], dtype=np.float32)
        self.buffer_offset = 0  # absolute samples dropped from audio_buffer
        # utterances that started before the previous one was flushed
        # (end+start inside one insert): staged FIFO until process_iter
        # finishes the old one, so online.init() never wipes an unflushed
        # tail. A LIST, not one slot — a large insert can stage several
        # utterances (start2/end2/start3), and overwriting would silently
        # drop utterance 2's audio. Entries: [abs_start, audio, ended].
        self._pending: list[list] = []
        # cumulative VAD end events — consumers (diarizer) compare counts
        # instead of before/after status, which misses an end+start pair
        # landing inside one inserted chunk (status stays 'voice')
        self.utterance_ends = 0

    # ------------------------------------------------------------------- audio

    def insert_audio_chunk(self, audio: np.ndarray) -> None:
        """Route a chunk by the VAD's events (the ``stream.insert`` span,
        the VAD included)."""
        with span("stream.insert"):
            self._insert_audio_chunk(audio)

    def _insert_audio_chunk(self, audio: np.ndarray) -> None:
        audio = np.asarray(audio, np.float32)
        events = self.vac(audio)
        self.audio_buffer = np.append(self.audio_buffer, audio)

        for ev in events:
            frame = list(ev.values())[0] - self.buffer_offset
            if "start" in ev:
                self.status = "voice"
                send_audio = self.audio_buffer[max(frame, 0) :]
                if self.is_currently_final or self._pending:
                    # previous utterance awaits its finish(): stage the new one
                    self._pending.append(
                        [max(frame, 0) + self.buffer_offset, send_audio.copy(), False]
                    )
                else:
                    self.online.init(offset=(max(frame, 0) + self.buffer_offset) / SAMPLING_RATE)
                    self.online.insert_audio_chunk(send_audio)
                    self.current_online_chunk_buffer_size += len(send_audio)
                self._clip_buffer()
            else:  # end
                self.status = "nonvoice"
                self.utterance_ends += 1
                cut = max(frame, 0)
                send_audio = self.audio_buffer[:cut]
                if self._pending:
                    self._pending[-1][1] = np.append(self._pending[-1][1], send_audio)
                    self._pending[-1][2] = True  # this staged utterance ended
                else:
                    self.online.insert_audio_chunk(send_audio)
                    self.current_online_chunk_buffer_size += len(send_audio)
                    self.is_currently_final = True
                # keep the post-end remainder: it belongs to the NEXT
                # utterance (its start may arrive later in this same chunk)
                self.buffer_offset += cut
                self.audio_buffer = self.audio_buffer[cut:]

        if not events:
            if self.status == "voice":
                if self._pending:
                    self._pending[-1][1] = np.append(self._pending[-1][1], audio)
                else:
                    self.online.insert_audio_chunk(audio)
                    self.current_online_chunk_buffer_size += len(audio)
                self._clip_buffer()
            else:
                # keep at most 1 s of lookback while silent (speech_pad window)
                keep = SAMPLING_RATE
                if len(self.audio_buffer) > keep:
                    self.buffer_offset += len(self.audio_buffer) - keep
                    self.audio_buffer = self.audio_buffer[-keep:]

    def _clip_buffer(self):
        self.buffer_offset += len(self.audio_buffer)
        self.audio_buffer = np.array([], dtype=np.float32)

    # ---------------------------------------------------------------- protocol

    def process_iter(self) -> tuple[Optional[float], Optional[float], str]:
        if self.is_currently_final:
            return self.finish()
        if self.current_online_chunk_buffer_size > SAMPLING_RATE * self.online_chunk_size:
            self.current_online_chunk_buffer_size = 0
            return self.online.process_iter()
        return (None, None, "")

    # two-phase tick (batched serving): wants_tick mirrors process_iter's
    # regular-tick gate; prepare_request consumes it; apply_result finishes.
    # The finish() path (is_currently_final) stays on process_iter.

    def wants_tick(self) -> bool:
        return (not self.is_currently_final) and (
            self.current_online_chunk_buffer_size > SAMPLING_RATE * self.online_chunk_size
        )

    def prepare_request(self) -> dict:
        self.current_online_chunk_buffer_size = 0
        return self.online.prepare_request()

    def apply_result(self, res, proc_delay_s: float = 0.0):
        return self.online.apply_result(res, proc_delay_s)

    def finish_all(self) -> list[tuple[Optional[float], Optional[float], str]]:
        """Drain the active utterance AND every staged one. ``finish()`` hands
        over exactly one staged utterance (_pending) per call, so a single
        finish at session end would drop any utterance whose end+start pair
        landed inside the final chunk."""
        out = []
        for _ in range(64):  # _pending strictly shrinks per call; cap = defense
            ret = self.finish()
            if ret[2]:
                out.append(ret)
            if not self._pending and self.current_online_chunk_buffer_size == 0:
                break
        return out

    def finish(self) -> tuple[Optional[float], Optional[float], str]:
        # transcribe any audio that never got a process_iter tick (short
        # utterances can end before reaching online_chunk_size), then flush
        head = (None, None, "")
        if self.current_online_chunk_buffer_size > 0 and len(self.online.audio_buffer) > 0:
            head = self.online.process_iter()
        tail = self.online.finish()
        if head[2] and tail[2]:
            ret = (head[0], tail[1], head[2] + self.online.asr.sep + tail[2])
        else:
            ret = tail if tail[2] else head
        self.current_online_chunk_buffer_size = 0
        self.is_currently_final = False
        if self._pending:
            # hand over the OLDEST staged utterance now that the old one is
            # flushed; later staged ones wait for their own finish() round
            start, buf, ended = self._pending.pop(0)
            self.online.init(offset=start / SAMPLING_RATE)
            if len(buf):
                self.online.insert_audio_chunk(buf)
                self.current_online_chunk_buffer_size += len(buf)
            # the handed-over utterance is itself final when its end event
            # already fired (per-entry flag — the live VAD status belongs to
            # the NEWEST utterance, not this one)
            if ended or (not self._pending and self.status == "nonvoice"):
                self.is_currently_final = True
        return ret

    # ----------------------------------------------------------------- control

    def set_silence_duration(self, ms: float) -> bool:
        """Runtime VAD silence adjustment — the L5→L3 extension the reference
        adds (`asr_components.py:36-51`, called from 一键…py:1638)."""
        try:
            self.vac.set_min_silence_duration_ms(ms)
            return True
        except Exception:
            return False

    def set_agreement_n(self, n: int) -> None:
        self.online.set_agreement_n(n)
