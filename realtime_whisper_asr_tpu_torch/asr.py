"""Whisper ASR backend on PyTorch/CUDA: the online protocol's ASR side.

Port of the single-stream greedy path of ``realtime_whisper_asr_tpu/asr.py``.
The protocol the online processor consumes (whisper_streaming's backend
contract):

    transcribe(audio, init_prompt="") -> segments
    ts_words(segments) -> [(beg, end, word)]
    segments_end_ts(segments) -> [end, ...]
    set_translate_task(); use_vad(); attribute ``sep``

Each window (tick) is: one host→device copy of the padded window and the
decode's aux bundle, from pinned memory → log-mel (the hand-written CUDA
kernel) → encoder → greedy decode with cross-attention capture (on the card
its loop replays CUDA graphs, ``decode.DecodeLoop``) → one device→host copy
of the packed result → segments with DTW word timestamps.

A window is ``transcribe_dispatch`` (everything up to the start of the
result's copy) then ``transcribe_finalize`` (the wait for that copy and the
parse); ``transcribe`` runs the two back to back, and the pipelined
streaming loop (``streaming/online.py``) puts the next tick's dispatch
between them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper import timestamps as TS
from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig, get_config
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper, init_params
from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import Tokenizer, get_tokenizer
from realtime_whisper_asr_tpu_torch.ops.logmel import log_mel_spectrogram
from realtime_whisper_asr_tpu_torch.utils.profiling import sync_device

logger = logging.getLogger(__name__)

SAMPLING_RATE = 16000
WINDOW_SECONDS = 30.0
WINDOW_SAMPLES = int(WINDOW_SECONDS * SAMPLING_RATE)


def _samples_to_words(audio: np.ndarray) -> np.ndarray:
    """Audio rides to the device as s16 PCM, two samples per f32 word (the
    JAX package's transfer encoding: half the bytes, and the same samples
    reach the model on both). Even length required."""
    q = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    return q.view(np.float32)


def _words_to_samples(words: torch.Tensor) -> torch.Tensor:
    return words.view(torch.int16).float() / 32768.0


@dataclasses.dataclass
class Word:
    start: float
    end: float
    word: str
    probability: float = 1.0


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    text: str
    words: list[Word]
    avg_logprob: float = 0.0
    no_speech_prob: float = 0.0


class TranscriptionResult(list):
    """A list of Segments that also carries the raw token ids of the window —
    the online processor feeds these back as the stable prefix of the next
    incremental re-decode (streaming/online.py)."""

    tokens: list[int]

    def __init__(self, segments, tokens=None):
        super().__init__(segments)
        self.tokens = tokens or []


class TorchWhisperASR:
    """Whisper backend on the card. ``sep=""`` — words carry their leading space."""

    sep = ""
    supports_prefix = True  # incremental re-decode via forced token prefix

    #: encoder window buckets (seconds): most streaming ticks encode the 8 s
    #: or 16 s bucket instead of the full 30 s pad
    WINDOW_BUCKETS_S = (8.0, 16.0, 30.0)

    def __init__(
        self,
        model_size: str = "tiny",
        language: Optional[str] = "en",
        params: Optional[dict] = None,
        cfg: Optional[WhisperConfig] = None,
        tokenizer: Optional[Tokenizer] = None,
        dtype=torch.bfloat16,
        seed: int = 0,
        word_timestamps: bool = True,
        device="cuda",
        quantization: Optional[str] = None,
    ):
        """``params``: a state dict of ``models.whisper.model.Whisper``
        (``convert.params_from_jax`` / ``convert.load_flat_npz``); random
        init from ``seed`` when None. Runs on the card unless ``device``
        says otherwise, and raises when CUDA is absent.

        ``quantization``, as the JAX backend's: None, ``"int8"`` (decoder
        block linears), ``"int8-all"`` (+ encoder blocks + tied head),
        ``"int4"`` (int4-g128 decoder blocks + int8 head) or ``"int4-all"``
        (+ int8 encoder blocks). The tier quantizes the weights before the
        model is built. ``"int8-kv"`` raises ``NotImplementedError`` (not
        ported yet), an unknown value ``ValueError``."""
        Q.tier_layout(quantization)  # raises on a tier not ported or unknown
        self.quantization = quantization if quantization not in ("", "none") else None
        self.device = resolve_device(device)
        self.cfg = cfg or get_config(model_size)
        if params is None:
            logger.warning("no weights provided; initializing %s with random weights",
                           self.cfg.name)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model = init_params(self.cfg, gen, dtype, self.device)
            if self.quantization:
                params = self.model.state_dict()
        if params is not None:
            state = Q.quantize(params, self.quantization)
            self.model = Whisper.empty(self.cfg, dtype, self.device, self.quantization)
            self.model.load_state_dict(state)
        self.tokenizer = tokenizer or get_tokenizer(self.cfg)
        #: (L, H) f32 weights for DTW cross-attention capture; None selects
        #: the top-half-layers default (decode._amask_dev)
        self.alignment_heads: Optional[np.ndarray] = None
        self.original_language = language if self.cfg.is_multilingual else None
        self.task = "transcribe"
        self.word_timestamps = word_timestamps
        self.transcribe_kargs: dict = {}
        #: anti-hallucination guard: cap the transcript per window at
        #: ``8 + rate × window_seconds`` tokens (real speech lands at ~3-4
        #: tokens/s), so a repetition loop on a short window stops early;
        #: None disables. Rides in the aux bundle as the exact cap, so it
        #: adds no loop shape.
        self.max_tokens_per_second: Optional[float] = None
        self._vad_flag = False  # protocol parity; VAD is the VAC processor's job
        #: the decode loop of every window: on the card its CUDA graphs, one
        #: per loop shape, captured at a shape's first window
        self.decode_loop = D.DecodeLoop()
        #: optional utils.profiling.PhaseTimer: when set, _transcribe_window
        #: waits for the card at each phase boundary and laps upload, encode,
        #: decode, download and host_parse. Diagnostic mode: the waits
        #: serialize work the host otherwise queues ahead.
        self.phase_timer = None
        #: one tick (window) = one h2d transfer, one log-mel launch, one encode
        self.counters = {"new_tokens": 0, "ticks": 0, "encoded_frames": 0,
                         "h2d_transfers": 0, "h2d_bytes": 0}
        non_speech = getattr(self.tokenizer, "non_speech_ids", None)
        self._extra_suppress = tuple(non_speech()) if non_speech else ()

    # ------------------------------------------------------------------ utils

    def _window_bucket(self, n_samples: int) -> int:
        for b in self.WINDOW_BUCKETS_S:
            nb = int(b * SAMPLING_RATE)
            if n_samples <= nb:
                return nb
        return nb

    def _pad_window(self, audio: np.ndarray) -> np.ndarray:
        """Zero-pad to the smallest bucket that fits (≤ 30 s)."""
        audio = audio[:WINDOW_SAMPLES]
        out = np.zeros(self._window_bucket(len(audio)), np.float32)
        out[: len(audio)] = audio
        return out

    def _upload(self, audio: np.ndarray, aux: np.ndarray):
        """ONE host→device copy, from pinned memory, of the padded window (as
        s16 words) and the decode's aux bundle -> (audio f32, aux) on the
        device."""
        words = _samples_to_words(self._pad_window(audio))
        host = torch.from_numpy(np.concatenate([words, aux]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        self.counters["h2d_transfers"] += 1
        self.counters["h2d_bytes"] += host.numel() * 4
        return _words_to_samples(dev[: len(words)]), dev[len(words):]

    def _logmel_encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(n,) f32 window on the device -> encoder output (1, n/320, d)."""
        mel = log_mel_spectrogram(audio, n_mels=self.cfg.n_mels)
        return self.model.encode(mel.to(self.model.dtype)[None])

    def _density_cap(self, max_new_cap: int, n_prefix: int, window_samples: int) -> int:
        """The plan's exact cap with the per-second transcript cap folded in
        (``max_tokens_per_second``); unchanged when that is None."""
        if self.max_tokens_per_second is None:
            return max_new_cap
        total = int(8 + self.max_tokens_per_second * window_samples / SAMPLING_RATE)
        return max(1, min(max_new_cap, total - n_prefix))

    def _make_opts(self) -> D.DecodeOptions:
        return D.DecodeOptions(
            task=self.task,
            language=self.original_language,
            timestamps=True,
            word_timestamps=self.word_timestamps,
            **self.transcribe_kargs,
        )

    # --------------------------------------------------------------- protocol

    @torch.inference_mode()
    def transcribe(
        self,
        audio: np.ndarray,
        init_prompt: str = "",
        prefix_ids: Optional[list[int]] = None,
        draft_ids: Optional[list[int]] = None,
    ) -> TranscriptionResult:
        """Transcribe 16 kHz float32 mono audio into segments.

        ``prefix_ids`` (stable tokens from the previous tick, incl. timestamp
        tokens) are force-decoded in the prefill pass so only the new tail
        costs autoregressive steps; ``draft_ids`` (the previous hypothesis's
        tail beyond that prefix) are verified in the same pass and accepted
        where the model agrees (lossless). Input longer than 30 s is windowed
        sequentially, each window's decoded text riding as the next window's
        prompt (condition_on_previous_text).
        """
        audio = np.asarray(audio, np.float32)
        if len(audio) <= WINDOW_SAMPLES:
            return self._transcribe_window(audio, init_prompt, 0.0, prefix_ids, draft_ids)
        segments: list[Segment] = []
        carry: list[int] = list(self.tokenizer.encode(init_prompt)) if init_prompt else []
        offset = 0
        while offset < len(audio):
            window = audio[offset : offset + WINDOW_SAMPLES]
            segs = self._transcribe_window(
                window, init_prompt, offset / SAMPLING_RATE, prompt_ids=carry
            )
            segments.extend(segs)
            # segs.tokens is the sampled region only, so this never
            # re-appends the carried context; < eot drops timestamp and
            # special tokens; keep the newest n_text_ctx//2 - 1
            carry.extend(t for t in segs.tokens if t < self.cfg.eot)
            del carry[: max(0, len(carry) - (self.cfg.n_text_ctx // 2 - 1))]
            if segs and segs[-1].end * SAMPLING_RATE > offset + 1:
                offset = int(segs[-1].end * SAMPLING_RATE)
            else:
                offset += WINDOW_SAMPLES
        return TranscriptionResult(segments)

    @torch.inference_mode()
    def transcribe_dispatch(
        self,
        audio: np.ndarray,
        init_prompt: str = "",
        prefix_ids: Optional[list[int]] = None,
        draft_ids: Optional[list[int]] = None,
        device_draft: Optional[dict] = None,
    ) -> dict:
        """The first half of ``transcribe`` for a window of ≤ 30 s: plan,
        upload, log-mel, encode and the decode up to the start of its
        result's copy. Returns a handle for ``transcribe_finalize``.

        ``device_draft`` (the async-pipelined streaming loop): ``{"packed",
        "offset", "max_new", "row_len", "force", "safety"}``, the previous
        tick's packed result still on the card, written into this tick's
        draft slots there (``decode.patch_aux_device_draft``) in place of
        ``draft_ids``. Longer input is windowed synchronously, as
        ``transcribe`` does, its result wrapped in the handle."""
        audio = np.asarray(audio, np.float32)
        if len(audio) > WINDOW_SAMPLES:
            return {"sync_result": self.transcribe(audio, init_prompt, prefix_ids, draft_ids)}
        return self._transcribe_window_dispatch(audio, init_prompt, 0.0, prefix_ids, draft_ids,
                                                device_draft=device_draft)

    def transcribe_finalize(self, st: dict) -> TranscriptionResult:
        """The second half of ``transcribe``: wait for the result's copy,
        then parse it."""
        if "sync_result" in st:
            return st["sync_result"]
        return self._transcribe_window_finalize(st)

    def _transcribe_window(
        self,
        audio: np.ndarray,
        init_prompt: str,
        time_offset: float,
        prefix_ids: Optional[list[int]] = None,
        draft_ids: Optional[list[int]] = None,
        prompt_ids: Optional[list[int]] = None,  # overrides init_prompt (carry)
    ) -> TranscriptionResult:
        return self._transcribe_window_finalize(self._transcribe_window_dispatch(
            audio, init_prompt, time_offset, prefix_ids, draft_ids, prompt_ids))

    def _transcribe_window_dispatch(
        self,
        audio: np.ndarray,
        init_prompt: str,
        time_offset: float,
        prefix_ids: Optional[list[int]] = None,
        draft_ids: Optional[list[int]] = None,
        prompt_ids: Optional[list[int]] = None,  # overrides init_prompt (carry)
        device_draft: Optional[dict] = None,
    ) -> dict:
        cfg = self.cfg
        opts = self._make_opts()
        if prompt_ids is None:
            prompt_ids = self.tokenizer.encode(init_prompt) if init_prompt else None
        plan = D.plan_window(cfg, opts, prompt_ids, prefix_ids, draft_ids,
                             force_draft_bucket=device_draft is not None)
        cap_slot = D.AUX_TOK + 4  # the exact cap the plan put in the aux bundle
        plan.aux[cap_slot] = self._density_cap(int(plan.aux[cap_slot]), plan.n_prefix,
                                               len(audio))
        pt = self.phase_timer
        if pt is not None:
            pt.mark()
        audio_dev, aux_dev = self._upload(audio, plan.aux)
        if device_draft is not None:
            D.patch_aux_device_draft(
                aux_dev.view(1, D.AUX_LEN), device_draft["packed"], device_draft["offset"],
                device_draft["max_new"], device_draft["row_len"], cfg.eot,
                force=device_draft["force"], safety=device_draft["safety"])
        if pt is not None:
            sync_device(self.device)
            pt.lap("upload")
        xa = self._logmel_encode(audio_dev)
        if pt is not None:
            sync_device(self.device)
            pt.lap("encode")
        handle = D.greedy_decode_dispatch(
            self.model, xa, opts, plan, aux_dev,
            extra_suppress=self._extra_suppress, alignment_heads=self.alignment_heads,
            loop=self.decode_loop, phase_timer=pt,
        )
        return {"decode_handle": handle, "prefix_ids": prefix_ids, "audio_len": len(audio),
                "time_offset": time_offset}

    def _transcribe_window_finalize(self, st: dict) -> TranscriptionResult:
        cfg = self.cfg
        result = D.greedy_decode_finalize(st["decode_handle"])
        n_frames = min(st["audio_len"] // (2 * 160), cfg.n_audio_ctx)
        self.counters["ticks"] += 1
        self.counters["new_tokens"] += int(result.lengths[0]) - len(st["prefix_ids"] or [])
        self.counters["encoded_frames"] += n_frames
        segs = self._parse_segments(result, n_frames, st["time_offset"])
        ids = result.tokens[0][: result.lengths[0]].tolist()
        if ids and ids[-1] == cfg.eot:
            ids = ids[:-1]
        if self.phase_timer is not None:
            self.phase_timer.lap("host_parse")
        return TranscriptionResult(segs, tokens=ids)

    def _parse_segments(
        self, result: D.DecodeResult, n_frames: int, time_offset: float
    ) -> list[Segment]:
        cfg = self.cfg
        ids = result.tokens[0][: result.lengths[0]].tolist()
        if ids and ids[-1] == cfg.eot:
            ids = ids[:-1]
        # word times via DTW over captured cross-attention
        words: list[tuple[float, float, str]] = []
        word_token_counts: list[int] = []
        if self.word_timestamps and result.xattn is not None and ids:
            words, word_token_counts = TS.word_timestamps(
                ids, result.xattn[0][: len(ids)], self.tokenizer, n_frames, time_offset,
                return_token_counts=True, language=self.original_language,
            )
        # split into segments at timestamp-token pairs
        segments: list[Segment] = []
        ts0 = cfg.timestamp_begin
        cur_text: list[int] = []
        seg_start = time_offset
        last_end = time_offset
        widx = 0
        for tok in ids:
            if tok >= ts0:
                t = time_offset + cfg.timestamp_to_seconds(tok)
                if cur_text:
                    # assign words whose tokens fall inside this segment's text
                    # tokens (words may span multiple tokens — count tokens,
                    # not words)
                    seg_words = []
                    seg_token_budget = sum(1 for i in cur_text if i < cfg.eot)
                    used = 0
                    while widx < len(words) and used < seg_token_budget:
                        b, e, wtext = words[widx]
                        used += word_token_counts[widx] if widx < len(word_token_counts) else 1
                        seg_words.append(Word(b, e, wtext))
                        widx += 1
                    segments.append(
                        Segment(
                            start=seg_start,
                            end=max(t, seg_start),
                            text=self.tokenizer.decode(cur_text),
                            words=seg_words,
                            avg_logprob=float(result.avg_logprob[0]),
                            no_speech_prob=float(result.no_speech_prob[0]),
                        )
                    )
                    cur_text = []
                seg_start = t
                last_end = t
            elif tok < cfg.eot:
                cur_text.append(tok)
        if cur_text:
            seg_words = [Word(b, e, w) for b, e, w in words[widx:]]
            end = seg_words[-1].end if seg_words else last_end + 2.0
            end = max(end, seg_start)
            segments.append(
                Segment(
                    start=seg_start,
                    end=end,
                    text=self.tokenizer.decode(cur_text),
                    words=seg_words,
                    avg_logprob=float(result.avg_logprob[0]),
                    no_speech_prob=float(result.no_speech_prob[0]),
                )
            )
        return segments

    def ts_words(self, segments: Sequence[Segment]) -> list[tuple[float, float, str]]:
        out = []
        for seg in segments:
            if seg.no_speech_prob > 0.9 and seg.avg_logprob < -1.0:
                continue
            for w in seg.words:
                out.append((w.start, w.end, w.word))
        return out

    def segments_end_ts(self, segments: Sequence[Segment]) -> list[float]:
        return [s.end for s in segments]

    def set_translate_task(self):
        self.task = "translate"

    def use_vad(self):
        self._vad_flag = True
