"""Whisper ASR backend on PyTorch/CUDA: the online protocol's ASR side.

Port of ``realtime_whisper_asr_tpu/asr.py``: greedy or beam decoding
(``beam_size``), whisper's quality-retry temperature ladder
(``temperature_fallback``, ``transcribe_with_fallback``) and
``detect_language``.
The protocol the online processor consumes (whisper_streaming's backend
contract):

    transcribe(audio, init_prompt="") -> segments
    ts_words(segments) -> [(beg, end, word)]
    segments_end_ts(segments) -> [end, ...]
    set_translate_task(); use_vad(); attribute ``sep``

Each window (tick) is: one host→device copy, from pinned memory, of the
window's new audio and the decode's aux bundle, the audio applied to the
stream's device audio ring (grow, shift or full: see ``_plan_upload``) →
log-mel (the hand-written CUDA kernel) of the ring's first window bucket →
encoder → greedy (or beam) decode with cross-attention capture (on the
card its loop replays CUDA graphs, ``decode.DecodeLoop``) → one device→host
copy of the packed result → segments with DTW word timestamps.

A window is ``transcribe_dispatch`` (everything up to the start of the
result's copy) then ``transcribe_finalize`` (the wait for that copy and the
parse); ``transcribe`` runs the two back to back, and the pipelined
streaming loop (``streaming/online.py``) puts the next tick's dispatch
between them.

``transcribe_batch`` (``transcribe_batch_dispatch`` / ``_finalize``) is the
multi-stream tick the server (``serving.py``) runs: B streams' new audio
and aux rows in one copy, each applied to its own ring, log-mel once per
row, one encode of B rows and one batched decode (``decode.greedy_decode_batch``,
or ``beam.beam_decode_batch``).

``set_separation_frontend`` fuses a trained vocal-separation net
(``models/separation_nn.py``) into the encode: every encoded window, the
padded bucket with its zero tail, is separated on the device before K1, as
the JAX package does in its fused log-mel and encode program.
``detect_language`` encodes its window unseparated, as there.
``adaptive_params`` (``pipeline.stretch.AdaptiveWhisperParams``), when set,
adds its beam size and temperature for its ``rate_class`` to each window's
decode options.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import zlib
from typing import Optional, Sequence

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.models import separation_nn as SEP
from realtime_whisper_asr_tpu_torch.models.whisper import beam as BM
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper import timestamps as TS
from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
    is_native_checkpoint,
    load_checkpoint,
)
from realtime_whisper_asr_tpu_torch.models.whisper.config import (
    LANGUAGES,
    WhisperConfig,
    get_config,
)
from realtime_whisper_asr_tpu_torch.models.whisper.load import load_checkpoint_dir
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper, encoder_flops, init_params
from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import Tokenizer, get_tokenizer
from realtime_whisper_asr_tpu_torch.ops.logmel import log_mel_spectrogram
from realtime_whisper_asr_tpu_torch.utils.profiling import new_rid, span

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


def _ring_shift_write(ring: torch.Tensor, samples: torch.Tensor, k: int,
                      n_remain: int) -> torch.Tensor:
    """A fresh ring: ``ring`` with its first ``k`` samples dropped (front
    trim: the retained audio is already on the device), zero past the
    ``n_remain`` retained samples, then ``samples`` written at
    ``n_remain``. A gather with clamped indices and a select, as the JAX
    package's ``_buf_shift_write``: no tensor is read and written at once."""
    idx = torch.arange(ring.shape[0], device=ring.device)
    src = ring[torch.clamp(idx + k, max=ring.shape[0] - 1)]
    out = torch.where(idx < n_remain, src, 0.0)
    out.narrow(0, n_remain, samples.shape[0]).copy_(samples)
    return out


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


def load_model_dir(path: str, dtype) -> tuple[WhisperConfig, dict]:
    """(config, state dict on the CPU, floats in ``dtype``) of a checkpoint
    directory: the port's native format when it has ``rtwa_config.json``
    (an orbax-only one raises ``ValueError``), else the HF layout."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    if is_native_checkpoint(path):
        return load_checkpoint(path, dtype)
    return load_checkpoint_dir(path, dtype)


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
        checkpoint_dir: Optional[str] = None,
        beam_size: int = 1,
    ):
        """``params``: a state dict of ``models.whisper.model.Whisper``
        (``convert.params_from_jax`` / ``convert.load_flat_npz``);
        ``checkpoint_dir``: a directory to load instead, the port's native
        checkpoint (``checkpoint.py``) or an HF-layout one (``load.py``),
        its floats cast to ``dtype`` before any quantization, and its
        ``generation_config.json`` alignment heads and tokenizer files used;
        random init from ``seed`` when neither is given. Runs on the card
        unless ``device`` says otherwise, and raises when CUDA is absent.

        ``quantization``, as the JAX backend's: None, ``"int8"`` (decoder
        block linears), ``"int8-all"`` (+ encoder blocks + tied head),
        ``"int8-kv"`` (``int8-all``'s weights + int8 KV caches), ``"int4"``
        (int4-g128 decoder blocks + int8 head) or ``"int4-all"`` (+ int8
        encoder blocks); an unknown value raises ``ValueError``. The tier
        quantizes the weights before the model is built. A pre-quantized
        checkpoint (``tools/convert_checkpoint.py``) is never weakened: a
        requested tier that ranks below the artifact's (``quant.RANK``)
        runs, and reports, the artifact's tier; with no tier requested the
        artifact's runs.

        ``beam_size`` > 1 decodes every window by beam search (``beam.py``);
        ``transcribe_kargs["beam_size"]`` overrides it. ``seed`` also seeds
        the quality-retry ladder's sampling (``_sample_seed``)."""
        Q.tier_layout(quantization)  # raises on an unknown tier
        quantization = quantization if quantization not in ("", "none") else None
        if checkpoint_dir is not None:
            cfg, params = load_model_dir(checkpoint_dir, dtype)
            pre_quant = Q.detect_quantization(params)
            if pre_quant is not None:
                logger.info("checkpoint carries pre-quantized weights (%s)", pre_quant)
                if Q.RANK[pre_quant] > Q.RANK.get(quantization, 0):
                    if quantization is not None:
                        logger.warning("checkpoint is pre-quantized %s; requested %r cannot "
                                       "weaken it: running (and reporting) %s",
                                       pre_quant, quantization, pre_quant)
                    quantization = pre_quant
        self.quantization = quantization
        #: ``int8-kv``: the decode's K/V caches as int8 rows + f32 row scales
        self._kv_quant = quantization == "int8-kv"
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
            if checkpoint_dir is not None:  # quantized on the device, tensor by tensor
                params = {k: v.to(self.device) for k, v in params.items()}
            # the card's and the CPU's quantizers agree bit for bit
            state = Q.quantize(params, self.quantization)
            # the layout the state has (an int8-all artifact run as int4
            # keeps its int8 encoder, as the JAX package's transforms do)
            layout = "int8-kv" if self._kv_quant else Q.detect_quantization(state)
            self.model = Whisper.empty(self.cfg, dtype, self.device, layout)
            self.model.load_state_dict(state)
        self.tokenizer = tokenizer or get_tokenizer(self.cfg, checkpoint_dir)
        #: (L, H) f32 weights for DTW cross-attention capture, from the
        #: checkpoint's generation_config.json ``alignment_heads`` (HF
        #: convention); None selects the top-half-layers default
        #: (decode._amask_dev)
        self.alignment_heads = self._load_alignment_heads(checkpoint_dir)
        self.original_language = language if self.cfg.is_multilingual else None
        self.task = "transcribe"
        self.beam_size = beam_size
        self.word_timestamps = word_timestamps
        self.transcribe_kargs: dict = {}
        #: the seed of the next sampled decode; each rung of the quality-retry
        #: ladder advances it by one first
        self._sample_seed = seed
        #: whisper's quality-retry ladder: a window whose transcript compresses
        #: too well (a repetition loop) or whose mean logprob is too low is
        #: decoded again, sampled at temperatures 0.2, 0.4 … 1.0, until one
        #: passes. Off by default (streaming stays deterministic);
        #: ``transcribe_with_fallback`` turns it on for one call
        self.temperature_fallback = False
        self.compression_ratio_threshold = 2.4
        self.logprob_threshold = -1.0
        #: input longer than 30 s is windowed, each window's text the next
        #: window's prompt (faster-whisper's condition_on_previous_text)
        self.condition_on_previous_text = True
        #: anti-hallucination guard: cap the transcript per window at
        #: ``8 + rate × window_seconds`` tokens (real speech lands at ~3-4
        #: tokens/s), so a repetition loop on a short window stops early;
        #: None disables. Rides in the aux bundle as the exact cap, so it
        #: adds no loop shape.
        self.max_tokens_per_second: Optional[float] = None
        self.adaptive_params = None  # optional AdaptiveWhisperParams (pipeline.stretch)
        #: the fused separation frontend: (the net's params in the port's
        #: layout on the device, its dilations) or None
        self._sep_frontend = None
        self._vad_flag = False  # protocol parity; VAD is the VAC processor's job
        #: the decode loop of every window: on the card its CUDA graphs, one
        #: per loop shape, captured at a shape's first window
        self.decode_loop = D.DecodeLoop()
        #: one tick (window) = one h2d transfer, one log-mel launch, one
        #: encode; a prefetch (``prefetch_audio``) is one h2d transfer more; a
        #: batched tick of B streams is one transfer, B log-mel launches and
        #: one encode of B rows. ``encode_flops``: the encoder's matmul FLOPs
        #: over the rows encoded (``model.encoder_flops``)
        self.counters = {"new_tokens": 0, "ticks": 0, "encoded_frames": 0,
                         "h2d_transfers": 0, "h2d_bytes": 0, "encode_flops": 0}
        #: per-stream device audio rings: key -> (ring (_CAP,) f32 on the
        #: device, the f32 audio it holds as the host last sent it). The ring
        #: is zero past that audio, so its first window bucket is the padded
        #: window.
        self._buffers: dict = {}
        self._active_stream = None
        non_speech = getattr(self.tokenizer, "non_speech_ids", None)
        self._extra_suppress = tuple(non_speech()) if non_speech else ()

    # ------------------------------------------------------------------ utils

    def _load_alignment_heads(self, checkpoint_dir) -> Optional[np.ndarray]:
        """The (L, H) 0/1 mask of ``generation_config.json``'s
        ``alignment_heads`` ([layer, head] pairs), or None when the file,
        the key or a valid pair list is missing."""
        if not checkpoint_dir:
            return None
        path = os.path.join(checkpoint_dir, "generation_config.json")
        try:
            with open(path) as f:
                heads = json.load(f).get("alignment_heads")
            if not heads:
                return None
            mask = np.zeros((self.cfg.n_text_layer, self.cfg.n_text_head), np.float32)
            for layer, head in heads:
                mask[layer, head] = 1.0
            return mask
        except (OSError, ValueError, KeyError, IndexError, TypeError, AttributeError):
            return None

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

    # ------------------------------------------------------ device audio ring

    #: upload chunk buckets (samples): the new audio suffix a plan carries
    _CHUNK_BUCKETS = (16000, 64000, WINDOW_SAMPLES)
    _CAP = WINDOW_SAMPLES + 64000  # device ring capacity (window + append slack)

    def _find_shift(self, mirror: np.ndarray, audio: np.ndarray) -> Optional[int]:
        """Find k > 0 with mirror[k:] == audio[:len(mirror)-k] (front trim).

        Any verified k is correct (content equality is the only requirement),
        so periodic audio with several candidates is fine. Bounded work: an
        8-sample signature scan + at most a few full verifications.
        """
        n_old = len(mirror)
        if n_old < 16 or len(audio) < 8:
            return None
        sig = audio[:8]
        wins = sliding_window_view(mirror, 8)
        cand = np.flatnonzero((wins == sig).all(axis=1))
        checked = 0
        for k in cand:
            k = int(k)
            if k == 0:
                continue
            m = n_old - k
            if len(audio) < m or len(audio) - m > self._CHUNK_BUCKETS[-1]:
                continue
            if np.array_equal(audio[:m], mirror[k:]):
                return k
            checked += 1
            if checked >= 4:
                break
        return None

    def _plan_upload(self, key, audio: np.ndarray) -> dict:
        """Decide grow / shift / full upload for one stream's buffer.

        - grow: the previous window is a prefix — upload only the bucketed
          new suffix, written into the ring in place;
        - shift: the previous window was front-trimmed (buffer trimming,
          streaming/online.py) — the retained audio is already on the device;
          shift it there and upload only the new suffix;
        - full: anything else (stream reset, utterance re-init).

        Payloads are s16 words (2 samples a word; ``_samples_to_words``).
        The plan carries the host mirror (the f32 audio) for the next
        tick's equality checks. A write that would run past ``_CAP`` makes
        the plan full; no write is clamped.
        """
        audio = np.asarray(audio, np.float32)[:WINDOW_SAMPLES]
        ring, mirror = self._buffers.get(key, (None, np.zeros(0, np.float32)))
        n_old = len(mirror)

        def _suffix_plan(kind: str, n_keep: int, shift_k: int = 0):
            new = audio[n_keep:]
            if kind == "grow" and not len(new):
                # buffer already resident (a prefetch_audio upload landed it):
                # no words ride the copy and no device write happens
                return {"kind": kind, "words": np.zeros(0, np.float32),
                        "pos": n_keep, "shift_k": 0, "n_new": 0, "mirror": audio}
            cb = next((b for b in self._CHUNK_BUCKETS if len(new) <= b), None)
            if cb is None or n_keep + cb > self._CAP:
                return None
            payload = np.zeros(cb, np.float32)
            payload[: len(new)] = new
            return {"kind": kind, "words": _samples_to_words(payload),
                    "pos": n_keep, "shift_k": shift_k, "n_new": len(new),
                    "mirror": audio}

        if ring is not None and len(audio) >= n_old and np.array_equal(audio[:n_old], mirror):
            plan = _suffix_plan("grow", n_old)
            if plan is not None:
                return plan
        if ring is not None:
            k = self._find_shift(mirror, audio)
            if k is not None:
                plan = _suffix_plan("shift", n_old - k, shift_k=k)
                if plan is not None:
                    return plan
        # full replace: the audio padded to the smallest chunk bucket that
        # fits (an utterance start carries ~1-2 s), written into a zeroed ring
        fb = next((b for b in self._CHUNK_BUCKETS if len(audio) <= b), self._CAP)
        full = np.zeros(min(fb, self._CAP), np.float32)
        full[: len(audio)] = audio
        return {"kind": "full", "words": _samples_to_words(full), "pos": None,
                "shift_k": 0, "n_new": len(audio), "mirror": audio}

    def _sync_many(self, keys, audios, aux_rows: np.ndarray) -> torch.Tensor:
        """ONE host→device copy for B streams' new audio and all aux rows ->
        the (B, AUX_LEN) aux rows on the device."""
        plans = [self._plan_upload(k, a) for k, a in zip(keys, audios)]
        return self._upload_and_apply(keys, plans, aux_rows).view(aux_rows.shape)

    @torch.inference_mode()
    def _upload_and_apply(self, keys, plans: list[dict], aux_rows) -> torch.Tensor:
        """ONE copy, from pinned memory, of the plans' words and the aux rows
        (None: none), then each plan applied to its stream's ring on the
        copy's stream -> the aux words on the device. The write positions
        and shift amounts are host integers the slices take directly. Every
        row reads its stream's ring as it was before the call: a group padded
        by repeating a row applies that stream's plan twice, and a second
        shift must not shift the shifted ring again.

        The caching host allocator records the copy's event on the pinned
        block, so the block is not reused before the copy has read it."""
        aux_flat = (np.zeros(0, np.float32) if aux_rows is None
                    else np.ascontiguousarray(aux_rows, np.float32).reshape(-1))
        host = torch.from_numpy(np.concatenate([p["words"] for p in plans] + [aux_flat]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        up = host.to(self.device, non_blocking=True)
        self.counters["h2d_transfers"] += 1
        self.counters["h2d_bytes"] += host.numel() * 4
        bases = [None if plan["kind"] == "full" else self._buffers[key][0]
                 for key, plan in zip(keys, plans)]
        off = 0
        for key, plan, base in zip(keys, plans, bases):
            n = len(plan["words"])
            samples = _words_to_samples(up[off : off + n])
            off += n
            if plan["kind"] == "full":
                ring = torch.nn.functional.pad(samples, (0, self._CAP - samples.shape[0]))
            elif plan["kind"] == "shift":
                ring = _ring_shift_write(base, samples, plan["shift_k"], plan["pos"])
            else:  # grow: in place (a tick already queued reads the ring first)
                ring = base
                if n:  # nothing new: a prefetch already landed the buffer
                    ring.narrow(0, plan["pos"], samples.shape[0]).copy_(samples)
            self._buffers[key] = (ring, plan["mirror"].copy())
        return up[off:]

    def prefetch_audio(self, audio: np.ndarray, key=None) -> bool:
        """Upload a stream's current buffer now, off the tick's path: called
        when audio is inserted (streaming/online.py), so the next tick's
        copy carries only the aux bundle. Returns True when a copy was made,
        False when the buffer was already resident. Safe to call any number
        of times between ticks: each call is incremental."""
        key = self._active_stream if key is None else key
        plan = self._plan_upload(key, np.asarray(audio, np.float32))
        if plan["kind"] == "grow" and plan["n_new"] == 0:
            return False
        self._upload_and_apply([key], [plan], None)
        return True

    def _sync_audio_and_aux(self, audio: np.ndarray, aux_np: np.ndarray) -> torch.Tensor:
        """Single-stream tick: one copy (see ``_sync_many``) -> aux on the device."""
        return self._sync_many([self._active_stream], [audio], aux_np.reshape(1, -1)).view(-1)

    def set_active_stream(self, key) -> None:
        """Select which per-stream device ring ``transcribe`` uses."""
        self._active_stream = key

    def drop_stream(self, key) -> None:
        self._buffers.pop(key, None)

    def _encode_from_buf(self, n_samples: int) -> torch.Tensor:
        """Log-mel and encoder over the active stream's ring, its first
        window bucket for ``n_samples`` of audio (zero past the audio)."""
        return self._encode_many([self._active_stream], [n_samples])

    def _encode_many(self, keys, n_samples_list) -> torch.Tensor:
        """B streams' windows in one encode -> (B, frames/2, d): every row
        at the group's largest window bucket (each ring is zero past its
        audio), separated as one batch when the frontend is set, K1 once
        per row, one ``model.encode`` of the stack."""
        with span("encode"):
            nb = max(self._window_bucket(n) for n in n_samples_list)
            self.counters["encode_flops"] += len(keys) * encoder_flops(self.cfg, nb // (2 * 160))
            windows = [self._buffers[k][0][:nb] for k in keys]
            if self._sep_frontend is not None:
                sep, dil = self._sep_frontend
                with span("encode.separate"):
                    windows = SEP.separate_vocals(sep, torch.stack(windows), dil=dil).unbind(0)
            with span("encode.logmel"):
                mels = [log_mel_spectrogram(w, n_mels=self.cfg.n_mels) for w in windows]
            with span("encode.model"):
                return self.model.encode(torch.stack(mels).to(self.model.dtype))

    def set_separation_frontend(self, sep_params) -> None:
        """Fuse a trained spectral-mask separator into the encode: every
        encoded window (its bucket, zero tail included) is separated on the
        device before its log-mel, as the JAX package separates inside its
        fused log-mel and encode program. ``sep_params``: the net's params in
        the JAX layout (``NeuralSeparator.params``); ``None`` removes the
        frontend. Host stages that read raw audio (the VAD, the dedup
        features) see the unseparated signal in this mode."""
        if sep_params is None:
            self._sep_frontend = None
            return
        dil, _ = SEP.arch_of(sep_params)
        self._sep_frontend = (SEP.params_from_jax(sep_params, self.device),
                              tuple(tuple(d) for d in dil))

    def _logmel_encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(n,) f32 window on the device -> encoder output (1, n/320, d),
        never separated (``detect_language``'s encode, as in the JAX
        package)."""
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
        kargs = dict(self.transcribe_kargs)
        if self.adaptive_params is not None:
            # speech-rate-adaptive decode params (reference asr_components.py:
            # 267-275 wires AdaptiveWhisperParams the same way)
            kargs.update(self.adaptive_params.get_transcribe_kwargs(
                getattr(self.adaptive_params, "rate_class", "normal")))
        return D.DecodeOptions(
            task=self.task,
            language=self.original_language,
            beam_size=kargs.pop("beam_size", self.beam_size),
            timestamps=True,
            word_timestamps=self.word_timestamps,
            **kargs,
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
        prompt while ``condition_on_previous_text`` is set.
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
                window, init_prompt, offset / SAMPLING_RATE,
                prompt_ids=carry if self.condition_on_previous_text else None,
            )
            segments.extend(segs)
            if self.condition_on_previous_text:
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

    def transcribe_batch(self, items: list[dict]) -> list[TranscriptionResult]:
        """A batched multi-stream tick: B streams in one upload, one encode
        of B rows, one batched decode and one download.

        ``items``: ``[{"key", "audio", "init_prompt"?, "prefix_ids"?,
        "draft_ids"?}]``, one per stream (its device ring is ``key``'s). The
        rows share the decode options, so callers group items by language
        and task. One item goes through ``transcribe``."""
        if len(items) == 1:
            it = items[0]
            self.set_active_stream(it["key"])
            return [self.transcribe(it["audio"], it.get("init_prompt") or "",
                                    it.get("prefix_ids"), it.get("draft_ids"))]
        return self.transcribe_batch_finalize(self.transcribe_batch_dispatch(items))

    @torch.inference_mode()
    def transcribe_batch_dispatch(self, items: list[dict]) -> dict:
        """The first half of ``transcribe_batch``: plan, upload, encode and
        the decode up to the start of its result's copy; returns a handle
        for ``transcribe_batch_finalize``. B is padded to a power of two by
        repeating the last item, so group sizes add few loop shapes; the pad
        rows are dropped in the finalize. With ``beam_size`` > 1 the decode
        is B streams' beam searches in one loop, each stream stopping on its
        own (``beam.beam_decode_batch_dispatch``); drafts are dropped."""
        rid = new_rid()
        with span("asr.dispatch", rid=rid):
            n_real = len(items)
            padded = list(items)
            while len(padded) & (len(padded) - 1):
                padded.append(padded[-1])
            with span("asr.plan"):
                opts = self._make_opts()
                keys, audios, requests = [], [], []
                beam = opts.beam_size > 1
                for it in padded:
                    prompt = it.get("init_prompt") or ""
                    requests.append({
                        "prompt_tokens": self.tokenizer.encode(prompt) if prompt else None,
                        "prefix_tokens": it.get("prefix_ids"),
                        "draft_tokens": None if beam else it.get("draft_ids"),
                        "seed": self._sample_seed})
                    audios.append(np.asarray(it["audio"], np.float32))
                    keys.append(it["key"])
                plan = D.plan_batch_aux(self.cfg, opts, requests)
                cap_slot = D.AUX_TOK + 4
                for row, audio in zip(plan.rows, audios):  # each row's per-second cap
                    row.aux[cap_slot] = self._density_cap(row.cap, row.n_prefix, len(audio))
            with span("asr.upload"):
                aux_dev = self._sync_many(keys, audios, plan.aux)
            xa = self._encode_many(keys, [len(a) for a in audios])
            dispatch = BM.beam_decode_batch_dispatch if beam else D.greedy_decode_batch_dispatch
            handle = dispatch(
                self.model, xa, opts, plan, aux_dev, extra_suppress=self._extra_suppress,
                alignment_heads=self.alignment_heads, loop=self.decode_loop)
        return {"handle": handle, "items": items, "requests": requests, "n_real": n_real,
                "beam": beam, "rid": rid}

    def transcribe_batch_finalize(self, st: dict) -> list[TranscriptionResult]:
        """The second half of ``transcribe_batch``: wait for the result's
        copy, then parse each real row's segments and tokens."""
        items, requests, n_real = st["items"], st["requests"], st["n_real"]
        finalize = BM.beam_decode_batch_finalize if st["beam"] else D.greedy_decode_batch_finalize
        with span("asr.finalize", rid=st["rid"]):
            results = finalize(st["handle"])
            out = []
            with span("asr.parse"):
                for it, res, req in zip(items[:n_real], results[:n_real], requests[:n_real]):
                    n_frames = min(len(it["audio"]) // (2 * 160), self.cfg.n_audio_ctx)
                    segs = self._parse_segments(res, n_frames, 0.0)
                    ids = res.tokens[0][: res.lengths[0]].tolist()
                    if ids and ids[-1] == self.cfg.eot:
                        ids = ids[:-1]
                    out.append(TranscriptionResult(segs, tokens=ids))
                    self.counters["ticks"] += 1
                    self.counters["new_tokens"] += (int(res.lengths[0])
                                                    - len(req["prefix_tokens"] or []))
        return out

    @torch.inference_mode()
    def transcribe_dispatch(
        self,
        audio: np.ndarray,
        init_prompt: str = "",
        prefix_ids: Optional[list[int]] = None,
        draft_ids: Optional[list[int]] = None,
        key=None,
        device_draft: Optional[dict] = None,
    ) -> dict:
        """The first half of ``transcribe`` for a window of ≤ 30 s: plan,
        upload, log-mel, encode and the decode up to the start of its
        result's copy. Returns a handle for ``transcribe_finalize``.
        ``key`` selects the stream's device ring for this call (the active
        stream when None).

        ``device_draft`` (the async-pipelined streaming loop): ``{"packed",
        "offset", "max_new", "row_len", "force", "safety"}``, the previous
        tick's packed result still on the card, written into this tick's
        draft slots there (``decode.patch_aux_device_draft``) in place of
        ``draft_ids``. Longer input is windowed synchronously, as
        ``transcribe`` does, its result wrapped in the handle."""
        audio = np.asarray(audio, np.float32)
        if len(audio) > WINDOW_SAMPLES:
            return {"sync_result": self.transcribe(audio, init_prompt, prefix_ids, draft_ids)}
        prev = self._active_stream
        if key is not None:
            self._active_stream = key
        try:
            return self._transcribe_window_dispatch(audio, init_prompt, 0.0, prefix_ids,
                                                    draft_ids, device_draft=device_draft)
        finally:
            self._active_stream = prev

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
        rid = new_rid()
        with span("asr.dispatch", rid=rid):
            with span("asr.plan"):
                opts = self._make_opts()
                beam = opts.beam_size > 1
                if prompt_ids is None:
                    prompt_ids = self.tokenizer.encode(init_prompt) if init_prompt else None
                if beam:  # a beam search verifies no draft, host or device
                    draft_ids = device_draft = None
                plan = D.plan_window(cfg, opts, prompt_ids, prefix_ids, draft_ids,
                                     force_draft_bucket=device_draft is not None,
                                     seed=self._sample_seed)
                cap_slot = D.AUX_TOK + 4  # the exact cap the plan put in the aux bundle
                plan.aux[cap_slot] = self._density_cap(int(plan.aux[cap_slot]), plan.n_prefix,
                                                       len(audio))
            with span("asr.upload"):
                aux_dev = self._sync_audio_and_aux(audio, plan.aux)
                if device_draft is not None:
                    D.patch_aux_device_draft(
                        aux_dev.view(1, D.AUX_LEN), device_draft["packed"],
                        device_draft["offset"], device_draft["max_new"],
                        device_draft["row_len"], cfg.eot, force=device_draft["force"],
                        safety=device_draft["safety"])
            xa = self._encode_from_buf(len(audio))
            dispatch = BM.beam_decode_dispatch if beam else D.greedy_decode_dispatch
            handle = dispatch(
                self.model, xa, opts, plan, aux_dev,
                extra_suppress=self._extra_suppress, alignment_heads=self.alignment_heads,
                loop=self.decode_loop,
            )
        return {"decode_handle": handle, "beam": beam, "xa": xa, "opts": opts,
                "prompt_ids": prompt_ids, "prefix_ids": prefix_ids, "audio_len": len(audio),
                "time_offset": time_offset, "rid": rid}

    def _transcribe_window_finalize(self, st: dict) -> TranscriptionResult:
        cfg = self.cfg
        finalize = BM.beam_decode_finalize if st["beam"] else D.greedy_decode_finalize
        with span("asr.finalize", rid=st["rid"]):
            result = finalize(st["decode_handle"])
            opts = st["opts"]
            if self.temperature_fallback and opts.temperature == 0.0:
                with span("asr.retry"):
                    result = self._quality_retry(result, st["xa"], opts, st["prompt_ids"],
                                                 st["prefix_ids"])
            with span("asr.parse"):
                n_frames = min(st["audio_len"] // (2 * 160), cfg.n_audio_ctx)
                self.counters["ticks"] += 1
                self.counters["new_tokens"] += int(result.lengths[0]) - len(st["prefix_ids"] or [])
                self.counters["encoded_frames"] += n_frames
                segs = self._parse_segments(result, n_frames, st["time_offset"])
                ids = result.tokens[0][: result.lengths[0]].tolist()
                if ids and ids[-1] == cfg.eot:
                    ids = ids[:-1]
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

    @torch.inference_mode()
    def _quality_retry(self, result: D.DecodeResult, xa: torch.Tensor, opts: D.DecodeOptions,
                       prompt_ids, prefix_ids) -> D.DecodeResult:
        """Whisper's quality-retry ladder, the JAX package's
        ``_quality_retry``: a result whose text compresses above
        ``compression_ratio_threshold`` (zlib; a repetition loop) or whose
        mean logprob is below ``logprob_threshold`` is decoded again from the
        same encoder output, greedy with sampling at 0.2, 0.4, 0.6, 0.8 and
        1.0, ``_sample_seed`` advanced by one before each rung; the first
        rung that passes is kept, else the last. The rungs share one loop
        shape (the temperature rides in the aux bundle), so on the card one
        captured graph serves them all."""
        def bad(res: D.DecodeResult) -> bool:
            ids = res.tokens[0][: res.lengths[0]].tolist()
            text = self.tokenizer.decode(ids).encode("utf-8")
            if len(text) > 16:
                ratio = len(text) / max(len(zlib.compress(text)), 1)
                if ratio > self.compression_ratio_threshold:
                    return True
            return float(res.avg_logprob[0]) < self.logprob_threshold

        if not bad(result):
            return result
        for t in (0.2, 0.4, 0.6, 0.8, 1.0):
            self._sample_seed += 1
            retry_opts = dataclasses.replace(opts, temperature=t)
            plan = D.plan_window(self.cfg, retry_opts, prompt_ids, prefix_ids,
                                 seed=self._sample_seed)
            retry = D.greedy_decode(
                self.model, xa, retry_opts, plan, torch.from_numpy(plan.aux).to(xa.device),
                extra_suppress=self._extra_suppress, alignment_heads=self.alignment_heads,
                loop=self.decode_loop)
            if not bad(retry):
                return retry
            result = retry
        return result

    def transcribe_with_fallback(self, audio: np.ndarray, init_prompt: str = ""):
        """Offline-quality path: ``transcribe`` with the quality-retry ladder on."""
        prev = self.temperature_fallback
        self.temperature_fallback = True
        try:
            return self.transcribe(audio, init_prompt)
        finally:
            self.temperature_fallback = prev

    @torch.inference_mode()
    def detect_language(self, audio: np.ndarray) -> tuple[str, float]:
        """(language, probability) from one decoder step at SOT over the
        window (≤ 30 s, padded to its bucket), normalized over the language
        tokens only (whisper's ``detect_language``); ("en", 1.0) for an
        English-only model."""
        cfg = self.cfg
        if not cfg.is_multilingual:
            return "en", 1.0
        window = torch.from_numpy(self._pad_window(np.asarray(audio, np.float32)))
        xa = self._logmel_encode(window.to(self.device))
        logits, _ = self.model.decode_step(
            torch.tensor([cfg.sot], device=self.device),
            torch.zeros((), dtype=torch.long, device=self.device), self.model.init_cache(xa))
        lang = logits[0, cfg.sot + 1 : cfg.sot + 1 + cfg.num_languages]
        probs = torch.softmax(lang, dim=-1).cpu().numpy()
        best = int(np.argmax(probs))
        return LANGUAGES[best], float(probs[best])

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
