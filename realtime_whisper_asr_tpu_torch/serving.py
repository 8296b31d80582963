"""Multi-stream serving: N concurrent streams over one shared model on the card.

Port of ``realtime_whisper_asr_tpu/serving.py``. Design:

- ONE ``TorchWhisperASR`` (weights loaded once) shared by all streams; each
  stream owns its host pipeline (VAC/online processor, skip detector) and a
  device audio ring inside the ASR keyed by its id, so switching streams
  costs nothing beyond its own window state.
- cooperative round-robin: ``step()`` runs one scheduling round over the
  streams with enough buffered voice; callers drive it from their event
  loop, or ``serve_forever`` runs it on a thread. Same-language regular
  ticks ride one batched tick (``asr.transcribe_batch_dispatch``: one
  upload, one encode of B rows, one decode loop of batch B), dispatched
  before the previous round's groups are finalized.
- per-stream backpressure via PerformanceMonitor: when the card falls
  behind, the server skips recognition ticks, with a probe tick after
  ``max_consecutive_sheds`` so the monitor's window refreshes.

With ``beam_size`` > 1 (the ASR's, or its ``transcribe_kargs``'s) a group's
tick is B streams' beam searches in one loop. ``diarize=True`` gives each
stream a speaker tracker over one shared embedder (``models/speaker.py``),
fed at the VAC's utterance ends, and labels each result. A ``separator``
that is a trained neural net is fused into the shared ASR's encode
(``asr.set_separation_frontend``: each batch's windows separated on the
card before K1); any other separates each fed chunk on the caller's thread.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.pipeline import SkipDetector
from realtime_whisper_asr_tpu_torch.services import PerformanceMonitor
from realtime_whisper_asr_tpu_torch.streaming import (
    OnlineASRProcessor,
    VACOnlineASRProcessor,
    VADIterator,
)

logger = logging.getLogger(__name__)

SR = 16000


@dataclasses.dataclass
class StreamResult:
    stream_id: int
    begin: float
    end: float
    text: str
    #: speaker label ("S1", ...) when the server runs with diarize=True:
    #: mid-utterance results carry a provisional classification of the
    #: utterance in progress (SpeakerTurnController.live_label), utterance
    #: finals the assignment made at the VAD boundary
    speaker: Optional[str] = None


class _Stream:
    def __init__(self, sid: int, processor, skip_detector, clock):
        self.sid = sid
        self.processor = processor
        self.skip_detector = skip_detector
        self.clock = clock
        self.pending_audio: deque[np.ndarray] = deque()
        self.buffered_samples = 0
        self.results: deque[StreamResult] = deque()
        self.closed = False
        self.ticks = 0
        self.skipped_ticks = 0
        self.consecutive_sheds = 0
        self.audio_since_tick = 0.0  # seconds drained but not yet transcribed
        self.language: Optional[str] = None
        self.inflight = False  # a dispatched tick awaits finalize
        self.diarizer = None  # per-stream SpeakerTurnController when diarize=True
        self._prev_vac_status: Optional[str] = None
        self._prev_utt_ends = 0  # consumed VAC end-event count (diarizer)


#: the share of the card's memory the cap leaves to the caching allocator's
#: fragmentation (reserved but not allocated), and the bytes it leaves to the
#: CUDA context, cuBLAS/cuDNN workspaces and the CUDA graphs' scratch: the
#: JAX package's constants (calibrated on a 16 GB TPU v5e), kept for the
#: card and held there by chip_smoke.py's phase_serving, which reads the
#: context's bytes (``torch.cuda.mem_get_info`` beside the allocator's
#: reserved bytes) and the fragmentation at the serving peak and fails if
#: either exceeds its constant
HOLD_BACK = 0.15
FIXED_BYTES = 3 * 2**30


def _hbm_safe_batch(cfg, param_bytes: int, hbm_bytes: Optional[int], kv_quant: bool = False,
                    itemsize: int = 2, beam_size: int = 1,
                    separation: Optional[dict] = None) -> Optional[int]:
    """Largest per-dispatch decode batch whose working set fits device
    memory, or None when the device's memory size is unknown (the CPU).

    The pipelined scheduler keeps up to TWO dispatched tick groups alive on
    the device at once (step() dispatches round N+1 before finalizing round
    N), as the JAX package's formula says, so the budget (the card's memory
    less ``HOLD_BACK``, the weights and ``FIXED_BYTES``) is split over two
    groups of ``_row_bytes`` a row. ``itemsize``: the bytes of the model's
    dtype; ``kv_quant``: the ``int8-kv`` tier's int8 caches; ``beam_size``:
    the beams of a stream; ``separation``: the fused separation frontend's
    params, when set."""
    if not hbm_bytes or cfg is None:
        return None
    budget = int(hbm_bytes * (1 - HOLD_BACK)) - int(param_bytes) - FIXED_BYTES
    return max(1, budget // (2 * _row_bytes(cfg, kv_quant, itemsize, beam_size, separation)))


def _row_bytes(cfg, kv_quant: bool = False, itemsize: int = 2, beam_size: int = 1,
               separation: Optional[dict] = None) -> int:
    """What one batch row (one stream) costs the card, from what the port
    allocates:

    - the decode loop's state of one row (``decode._new_state``, or
      ``beam.new_state`` for K = ``beam_size`` > 1) at the largest loop
      shape: the 30 s window bucket (``n_audio_ctx`` cross frames), K self
      caches of ``n_text_ctx`` positions and one cross K/V, K × 224 capture
      rows (the largest loop bound) and K × ``n_text_ctx`` token slots; a
      beam row adds its (K, K, ``n_text_ctx``) f32 ancestry table. Cross and
      self K/V in the model's dtype, or under ``kv_quant`` int8 rows plus an
      f32 scale a row of Dh;
    - times ``decode.MAX_GRAPHS``: each loop shape the ``DecodeLoop`` keeps
      holds its own state buffers for its batch rows (the two groups in
      flight run in two of them);
    - plus the encoder's score transient of one row at the 30 s bucket: the
      f32 scores and their scaled copy and the softmax weights cast to the
      model's dtype, ``n_audio_head × n_audio_ctx²`` elements each (one
      layer's at a time);
    - plus, with the fused separation frontend (``separation``: its params),
      the separation's transient of one row at the 30 s bucket
      (``separation_nn.separation_bytes``: the widest conv's input and
      output, 1,876 frames × 513 bins each channel, beside the spectrum),
      since a batch's rows are separated together.

    ``tests/test_torch_serving.py`` holds the state part equal to
    ``decode._state_bytes`` of states allocated at that shape."""
    from realtime_whisper_asr_tpu_torch.models.whisper.decode import MAX_GRAPHS

    k, ctx = beam_size, cfg.n_text_ctx
    dh = cfg.n_text_state // cfg.n_text_head
    elems = 2 * cfg.n_text_layer * cfg.n_text_state * (k * ctx + cfg.n_audio_ctx)
    kv = elems + elems // dh * 4 if kv_quant else elems * itemsize
    capture = k * 224 * cfg.n_audio_ctx * 4
    if k == 1:  # tokens; finished, sum_lp, last_ts, total, n_prefix, seed, temp
        scalars = ctx * 8 + 1 + 4 + 8 + 8 + 8 + 8 + 4
    else:  # tokens, ancestry; finished, scores, last_ts; total, n_prefix
        scalars = k * ctx * 8 + k * k * ctx * 4 + k * (1 + 4 + 8) + 8 + 8
    state_row = kv + capture + scalars
    scores = cfg.n_audio_head * cfg.n_audio_ctx**2 * (2 * 4 + itemsize)
    sep = 0
    if separation is not None:
        from realtime_whisper_asr_tpu_torch.models.separation_nn import separation_bytes

        sep = separation_bytes(separation, cfg.n_audio_ctx * 2 * 160)
    return MAX_GRAPHS * state_row + scores + sep


def _device_batch_cap(asr) -> Optional[int]:
    """``_hbm_safe_batch`` for a model on the card: its parameter and
    buffer bytes (the int8/int4 weights are buffers), its dtype, cache kind,
    beams and separation frontend, and the card's memory; None for a
    backend without a model or one on the CPU."""
    model = getattr(asr, "model", None)
    cfg = getattr(asr, "cfg", None)
    device = getattr(asr, "device", None)
    if model is None or cfg is None or device is None or torch.device(device).type != "cuda":
        return None
    nbytes = sum(t.numel() * t.element_size()
                 for t in itertools.chain(model.parameters(), model.buffers()))
    dtype = getattr(model, "dtype", torch.bfloat16)
    itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) else 2
    return _hbm_safe_batch(cfg, nbytes, torch.cuda.get_device_properties(device).total_memory,
                           kv_quant=bool(getattr(model, "kv_quant", False)), itemsize=itemsize,
                           beam_size=_beam_size(asr), separation=_separation_params(asr))


def _separation_params(asr) -> Optional[dict]:
    """The params of the ASR's fused separation frontend, or None."""
    frontend = getattr(asr, "_sep_frontend", None)
    return frontend[0] if frontend is not None else None


def _beam_size(asr) -> int:
    """The beams of the ASR's decode: ``transcribe_kargs["beam_size"]``,
    else its ``beam_size``, else 1."""
    return int(getattr(asr, "transcribe_kargs", {}).get("beam_size",
                                                        getattr(asr, "beam_size", 1)))


def _silero_factory(device) -> Callable[[], object]:
    """A factory of Silero-like VADs on ``device`` sharing ONE net with the
    packaged weights, loaded once: each stream's VAD keeps its own LSTM
    state, and N streams hold one copy of the net."""
    from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD

    net = SileroLikeVAD(device=device).net
    return lambda: SileroLikeVAD(net=net)


class StreamServer:
    def __init__(
        self,
        asr,
        vad_factory: Optional[Callable[[], object]] = None,
        online_chunk_size: float = 1.0,
        agreement_n: int = 2,
        prefix_policy: str = "agree2",
        min_silence_duration_ms: int = 500,
        use_vad: bool = True,
        max_consecutive_sheds: int = 3,
        max_batch: int = 8,
        diarize: bool = False,
        separator=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        #: the vocal-separation frontend. A trained neural separator fuses
        #: into the shared ASR's encode (every batch's windows separated on
        #: the card before K1, no host cost per stream) and feed() passes
        #: audio through; any other separator runs in feed(), on the
        #: caller's thread, outside the locks (one shared instance: the
        #: separators keep no state but their stats). Fused before the
        #: memory cap below, which counts the frontend's transient.
        self.fused_separation = False
        if (
            separator is not None
            and getattr(separator, "name", "") == "neural"
            and getattr(separator, "trained", False)
            and hasattr(asr, "set_separation_frontend")
        ):
            asr.set_separation_frontend(separator.params)
            self.fused_separation = True
            separator = None
        self.separator = separator
        #: memory-derived ceiling on the per-dispatch batch (None: unknown
        #: memory). A larger max_batch is clamped, not honored-then-OOM: the
        #: scheduler still serves every stream by splitting each round into
        #: cap-sized groups.
        self.device_batch_cap = _device_batch_cap(asr)
        if self.device_batch_cap is not None and max_batch > self.device_batch_cap:
            logger.warning(
                "max_batch %d exceeds the memory-safe decode batch %d for this "
                "model/device; clamping (streams beyond the cap are served in "
                "additional per-round groups)",
                max_batch, self.device_batch_cap,
            )
            max_batch = self.device_batch_cap
        self.max_batch = max_batch
        self.max_consecutive_sheds = max_consecutive_sheds
        self.asr = asr
        # streams created with language=None must not inherit whatever language
        # the previously active stream set on the shared ASR
        self._default_language = getattr(asr, "original_language", None)
        self.clock = clock
        self.use_vad = use_vad
        self.online_chunk_size = online_chunk_size
        self.agreement_n = agreement_n
        self.prefix_policy = prefix_policy
        self.min_silence_duration_ms = min_silence_duration_ms
        if vad_factory is None and use_vad:
            vad_factory = _silero_factory(getattr(asr, "device", "cuda"))
        self.vad_factory = vad_factory
        # one shared (stateless) speaker embedder; per-stream trackers
        self._speaker_embedder = None
        if diarize and use_vad:
            from realtime_whisper_asr_tpu_torch.models.speaker import SpeakerEmbedder

            self._speaker_embedder = SpeakerEmbedder()
        self.streams: dict[int, _Stream] = {}
        self.monitor = PerformanceMonitor()
        self._ids = itertools.count(1)
        self._rr: deque[int] = deque()  # round-robin order
        self._lock = threading.Lock()  # guards queues/results/rr/stream maps
        self._asr_lock = threading.Lock()  # serializes shared-ASR access
        #: dispatched-but-not-finalized tick groups (guarded by _asr_lock):
        #: step() dispatches this round's groups BEFORE finalizing last
        #: round's, so group N+1's upload, encode and decode queue on the card
        #: behind group N's decode.
        self._inflight: list[dict] = []
        #: tick groups lost to a swallowed transcribe/dispatch/finalize
        #: exception (the group is reset and keeps serving), surfaced in
        #: get_stats so a systematically failing backend is visible.
        self.group_failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- streams

    def create_stream(self, language: Optional[str] = None) -> int:
        online = OnlineASRProcessor(
            self.asr,
            agreement_n=self.agreement_n,
            prefix_policy=self.prefix_policy,
            clock=self.clock,
        )
        if self.use_vad:
            processor = VACOnlineASRProcessor(
                online,
                VADIterator(self.vad_factory(),
                            min_silence_duration_ms=self.min_silence_duration_ms),
                online_chunk_size=self.online_chunk_size,
            )
        else:
            processor = online
        sid = next(self._ids)
        # route this processor's upload prefetches to its own device ring
        # (the shared ASR's "active stream" only tracks the ticking stream)
        online.stream_key = sid
        stream = _Stream(sid, processor, SkipDetector(clock=self.clock), self.clock)
        stream.language = language
        if self._speaker_embedder is not None:
            from realtime_whisper_asr_tpu_torch.models.speaker import (
                SpeakerTracker,
                SpeakerTurnController,
            )

            stream.diarizer = SpeakerTurnController(
                SpeakerTracker(embedder=self._speaker_embedder)
            )
        with self._lock:
            self.streams[sid] = stream
            self._rr.append(sid)
        logger.info("stream %d created (language=%s)", sid, language)
        return sid

    def _get_open(self, stream_id: int) -> _Stream:
        s = self.streams.get(stream_id)
        if s is None or s.closed:
            raise ValueError(f"stream {stream_id} is closed or unknown")
        return s

    def feed(self, stream_id: int, chunk: np.ndarray) -> None:
        if self.separator is not None:
            # outside the lock: separation is the expensive part of feed and
            # must not serialize other connections' feeds or step()'s drain
            chunk = self.separator.separate(np.asarray(chunk, np.float32))
        with self._lock:
            s = self._get_open(stream_id)
            s.pending_audio.append(np.asarray(chunk, np.float32))
            s.buffered_samples += len(chunk)

    def poll(self, stream_id: int) -> list[StreamResult]:
        with self._lock:
            s = self.streams.get(stream_id)
            if s is None:
                return []
            out = list(s.results)
            s.results.clear()
        return out

    def close_stream(self, stream_id: int) -> list[StreamResult]:
        """Final flush (transcribes any remaining audio); returns remaining
        results and forgets the stream."""
        with self._lock:
            s = self._get_open(stream_id)
            s.closed = True  # feed() rejects from here on
            if stream_id in self._rr:
                self._rr.remove(stream_id)
        with self._asr_lock:
            # a dispatched tick may still be in flight for this (or any)
            # stream — settle it before the final flush
            self._flush_inflight_locked()
            self._drain_into_processor(s)
            self._activate(s)
            # run a final transcription tick over whatever audio remains —
            # finish() only flushes already-hypothesized words. Loop because
            # VAC may hold a STAGED utterance (_pending: end+start inside the
            # client's last chunk): each finish() hands one over; a single
            # pass would silently drop its transcript.
            inner = getattr(s.processor, "online", s.processor)
            for _ in range(8):  # staged utterances hand over one per finish()
                if len(getattr(inner, "audio_buffer", ())) > 0:
                    beg, end, text = inner.process_iter()
                    if hasattr(s.processor, "current_online_chunk_buffer_size"):
                        # this WAS the head tick — don't let VAC.finish()
                        # re-run the same buffer (it gates on this counter)
                        s.processor.current_online_chunk_buffer_size = 0
                    self._emit(s, beg, end, text)
                had_pending = bool(getattr(s.processor, "_pending", None))
                beg, end, text = s.processor.finish()
                self._emit(s, beg, end, text)
                if not had_pending:
                    break
            if hasattr(self.asr, "drop_stream"):
                self.asr.drop_stream(stream_id)
        out = self.poll(stream_id)
        with self._lock:
            self.streams.pop(stream_id, None)  # no leaks on stream churn
        return out

    # -------------------------------------------------------------- scheduling

    def _activate(self, s: _Stream) -> None:
        if hasattr(self.asr, "set_active_stream"):
            self.asr.set_active_stream(s.sid)
        if hasattr(self.asr, "original_language"):
            self.asr.original_language = (
                s.language if s.language is not None else self._default_language
            )

    def _drain_into_processor(self, s: _Stream) -> None:
        while True:
            with self._lock:
                if not s.pending_audio:
                    return
                chunk = s.pending_audio.popleft()
                s.buffered_samples -= len(chunk)
            s.audio_since_tick += len(chunk) / SR
            s.processor.insert_audio_chunk(chunk)
            if s.diarizer is not None:
                status = getattr(s.processor, "status", None)
                s.diarizer.observe_chunk(chunk, voiced=(status == "voice"))
                ends = getattr(s.processor, "utterance_ends", None)
                if ends is not None:
                    # count VAC end events: a before/after status compare
                    # misses an end+start pair inside one chunk. A counter
                    # below the watermark means the processor was re-inited
                    # (error reset): resync without inventing events.
                    if ends < s._prev_utt_ends:
                        s._prev_utt_ends = ends
                    for _ in range(ends - s._prev_utt_ends):
                        s.diarizer.on_utterance_end()
                    s._prev_utt_ends = ends
                elif s._prev_vac_status == "voice" and status == "nonvoice":
                    s.diarizer.on_utterance_end()
                s._prev_vac_status = status

    def _emit(self, s: _Stream, beg, end, text) -> None:
        if not text:
            return
        skip, _ = s.skip_detector.should_skip(text, self.clock())
        if skip:
            return
        # live_label: the utterance in progress's provisional speaker, exact
        # at utterance finals (on_utterance_end runs in the drain, before
        # the final text is emitted)
        speaker = s.diarizer.live_label() if s.diarizer is not None else None
        with self._lock:
            s.results.append(StreamResult(s.sid, beg, end, text, speaker=speaker))

    def _collect_ready(self) -> list[_Stream]:
        """Pick up to max_batch ready streams in round-robin order."""
        with self._lock:
            order = list(self._rr)
        out: list[_Stream] = []
        for sid in order:
            with self._lock:
                s = self.streams.get(sid)
                # readiness = pending audio OR audio already drained into the
                # processor by a shed tick that still awaits transcription;
                # a stream with a dispatched tick in flight is not re-ticked
                if s is None or s.closed or s.inflight or (
                    s.buffered_samples < 1 and s.audio_since_tick <= 0
                ):
                    continue
                # rotate under the lock; a concurrent close may have removed it
                try:
                    self._rr.remove(sid)
                    self._rr.append(sid)
                except ValueError:
                    continue
            out.append(s)
            if len(out) >= self.max_batch:
                break
        return out

    def _tick_single(self, s: _Stream) -> None:
        self._activate(s)
        t0 = self.clock()
        beg, end, text = s.processor.process_iter()
        dt = self.clock() - t0
        s.ticks += 1
        # every real tick updates the window, with the audio actually
        # processed since the last tick (not the committed-word span)
        self.monitor.record_recognition(max(s.audio_since_tick, 1e-3), max(dt, 1e-6))
        s.audio_since_tick = 0.0
        self._emit(s, beg, end, text)

    def _reset_group(self, group: list[_Stream]) -> None:
        for s in group:
            s.inflight = False
            inner = getattr(s.processor, "online", s.processor)
            inner.init(offset=inner.buffer_time_offset
                       + len(inner.audio_buffer) / SR)

    def _requests(self, group: list[_Stream]) -> list[dict]:
        self._activate(group[0])  # language is uniform within the group
        reqs = []
        for s in group:
            r = s.processor.prepare_request()
            r["key"] = s.sid
            reqs.append(r)
        return reqs

    def _tick_batch(self, group: list[_Stream]) -> None:
        """ONE batched transcribe across same-language streams: a decode
        step at batch 1 reads all the decoder's weights for one row, so B
        streams share one weight pass (and one upload and download)."""
        reqs = self._requests(group)
        t0 = self.clock()
        try:
            results = self.asr.transcribe_batch(reqs)
        except Exception:
            logger.exception("batched transcribe failed; resetting group")
            self.group_failures += 1
            self._reset_group(group)
            return
        self._apply_batch(group, results, self.clock() - t0)

    def _dispatch_batch(self, group: list[_Stream]) -> Optional[dict]:
        """Pipelined first half of _tick_batch: plan, upload, encode and the
        decode up to its result's copy. Returns an in-flight record for
        _finalize_batch, or None if the dispatch failed."""
        reqs = self._requests(group)
        t0 = self.clock()
        try:
            st = self.asr.transcribe_batch_dispatch(reqs)
        except Exception:
            logger.exception("batched dispatch failed; resetting group")
            self.group_failures += 1
            self._reset_group(group)
            return None
        for s in group:
            s.inflight = True
        return {"group": group, "state": st, "t0": t0}

    def _finalize_batch(self, pending: dict) -> None:
        group = pending["group"]
        try:
            results = self.asr.transcribe_batch_finalize(pending["state"])
        except Exception:
            logger.exception("batched finalize failed; resetting group")
            self.group_failures += 1
            self._reset_group(group)
            return
        for s in group:
            s.inflight = False
        self._apply_batch(group, results, self.clock() - pending["t0"])

    def _apply_batch(self, group: list[_Stream], results, dt: float) -> None:
        # dt spans dispatch→finalize; under pipelining it includes overlap
        # with neighboring groups, so the per-stream share is a conservative
        # (over-)estimate for the load-shedding monitor
        share = dt / max(len(group), 1)
        for s, res in zip(group, results):
            beg, end, text = s.processor.apply_result(res, dt)
            s.ticks += 1
            self.monitor.record_recognition(max(s.audio_since_tick, 1e-3), max(share, 1e-6))
            s.audio_since_tick = 0.0
            self._emit(s, beg, end, text)

    def step(self) -> bool:
        """Run one scheduling round: drain + shed-check the ready streams,
        batch the same-language regular ticks into one transcribe, run the
        rest (utterance finals) individually.

        Pipelining: this round's batch groups are DISPATCHED (upload, encode
        and decode queued), then LAST round's in-flight groups are finalized,
        so each group's result copy overlaps the next group's work. Results
        for a group surface one ``step()`` later; callers drive ``step()`` in
        a loop (serve_forever / ``while step()``)."""
        candidates = self._collect_ready()
        with self._asr_lock:
            if not candidates and not self._inflight:
                return False
            did_work = False
            pipelined = hasattr(self.asr, "transcribe_batch_dispatch")
            batchable: list[_Stream] = []
            singles: list[_Stream] = []
            for s in candidates:
                with self._lock:
                    if s.closed:
                        continue
                self._drain_into_processor(s)
                skip, why = self.monitor.should_skip_recognition(max(s.audio_since_tick, 0.1))
                # probe-through: never shed indefinitely, or the monitor's
                # window never refreshes and shedding becomes a deadlock
                if skip and s.consecutive_sheds < self.max_consecutive_sheds:
                    s.skipped_ticks += 1
                    s.consecutive_sheds += 1
                    logger.debug("shedding load on stream %d: %s", s.sid, why)
                    did_work = True
                    continue
                s.consecutive_sheds = 0
                proc = s.processor
                if (
                    hasattr(self.asr, "transcribe_batch")
                    and hasattr(proc, "wants_tick")
                    and hasattr(proc, "prepare_request")
                ):
                    if proc.wants_tick():
                        batchable.append(s)
                    elif getattr(proc, "is_currently_final", False) or not hasattr(
                        proc, "is_currently_final"
                    ):
                        singles.append(s)
                    # else: VAC gate not met — nothing to do this round
                else:
                    singles.append(s)
            # group batchable streams by language (DecodeOptions are shared
            # across a batch); stragglers run individually (un-pipelined mode)
            new_inflight: list[dict] = []
            while batchable:
                lang = batchable[0].language
                group = [s for s in batchable if s.language == lang]
                batchable = [s for s in batchable if s.language != lang]
                if pipelined:
                    pending = self._dispatch_batch(group)
                    if pending is not None:
                        new_inflight.append(pending)
                    did_work = True
                elif len(group) == 1:
                    singles.extend(group)
                else:
                    self._tick_batch(group)
                    did_work = True
            for s in singles:
                self._tick_single(s)
                did_work = True
            # finalize LAST round's dispatches (their copies overlapped this
            # round's dispatch and singles work)
            for pending in self._inflight:
                self._finalize_batch(pending)
                did_work = True
            self._inflight = new_inflight
        return did_work

    def _flush_inflight_locked(self) -> None:
        """Finalize every in-flight group now (callers hold _asr_lock)."""
        for pending in self._inflight:
            self._finalize_batch(pending)
        self._inflight = []

    def serve_forever(self, idle_sleep: float = 0.01) -> None:
        while not self._stop.is_set():
            if not self.step():
                time.sleep(idle_sleep)

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self.serve_forever, daemon=True,
                                            name="rtwa-server")
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        with self._asr_lock:
            self._flush_inflight_locked()

    def get_stats(self) -> dict:
        with self._lock:
            return {
                "streams": len([s for s in self.streams.values() if not s.closed]),
                "total_streams": len(self.streams),
                "group_failures": self.group_failures,
                "max_batch": self.max_batch,
                "device_batch_cap": self.device_batch_cap,
                "separator": (self.separator.get_stats() if self.separator
                              else {"fused": True} if self.fused_separation
                              else None),
                "monitor": self.monitor.get_status(),
                "per_stream": {
                    sid: {"ticks": s.ticks, "shed": s.skipped_ticks,
                          "pending_s": s.buffered_samples / SR}
                    for sid, s in self.streams.items()
                },
            }
