"""OnlineASRProcessor: the streaming re-transcription loop.

The L5→L3 online protocol of SURVEY.md §1 — ``init(offset)``,
``insert_audio_chunk(float32[...])``, ``process_iter() -> (beg, end, text) |
(None, None, "")``, ``finish()`` — implemented once with the reference's two
processor variants unified behind options:

- LocalAgreement-n commits (agreement_n, reference enhanced_asr_processor.py:383)
- segment-boundary buffer trimming at ``buffer_trimming_sec`` (default 15 s,
  reference 一键实时识别麦克风.py:1992)
- dynamic trimming window 5–30 s driven by processing delay and host memory
  (reference DynamicBufferManager, enhanced_asr_processor.py:159-236)
- word-boundary prompt carry of the last ``prompt_chars`` committed characters
  as ``init_prompt`` (reference enhanced_asr_processor.py:295-341)
- exception → ``init(offset)`` reset recovery (enhanced_asr_processor.py:369-381)

StreamState (audio buffer, committed words, offsets, hypothesis state) is
explicitly serializable for checkpoint/resume (SURVEY.md §5).

Ticks are synchronous by default: ``process_iter`` runs one ``transcribe``
and applies its result before it returns. ``pipeline=True`` ("exact") or
``"async"`` splits each tick into the ASR's ``transcribe_dispatch`` and
``transcribe_finalize`` and overlaps one tick with the next (see the
constructor).
"""

from __future__ import annotations

import logging
import os
import time as _time
from typing import Callable, Optional

import numpy as np

from realtime_whisper_asr_tpu_torch.streaming.hypothesis import HypothesisBuffer, Word
from realtime_whisper_asr_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

SAMPLING_RATE = 16000


class DynamicBufferManager:
    """Adjusts the trimming window between min/max by latency and memory."""

    def __init__(
        self,
        initial_sec: float = 15.0,
        min_sec: float = 5.0,
        max_sec: float = 30.0,
        delay_threshold_s: float = 3.0,
        memory_threshold: float = 0.80,
        step_sec: float = 2.5,
    ):
        self.current = initial_sec
        self.min_sec = min_sec
        self.max_sec = max_sec
        self.delay_threshold_s = delay_threshold_s
        self.memory_threshold = memory_threshold
        self.step_sec = step_sec

    def _memory_fraction(self) -> float:
        try:
            info: dict[str, float] = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    key, val = line.split(":", 1)
                    info[key] = float(val.split()[0])
            return 1.0 - info.get("MemAvailable", info.get("MemFree", 0.0)) / info["MemTotal"]
        except Exception:
            return 0.0

    def adjust(self, processing_delay_s: float) -> float:
        if processing_delay_s > self.delay_threshold_s or self._memory_fraction() > self.memory_threshold:
            self.current = max(self.min_sec, self.current - self.step_sec)
        else:
            self.current = min(self.max_sec, self.current + self.step_sec / 5.0)
        return self.current


class OnlineASRProcessor:
    SAMPLING_RATE = SAMPLING_RATE

    def __init__(
        self,
        asr,
        agreement_n: int = 2,
        buffer_trimming: tuple[str, float] = ("segment", 15.0),
        prompt_chars: int = 300,
        dynamic_buffer: bool = False,
        incremental_prefix: bool = True,
        prefix_policy: str = "agree2",  # agree2 | last (SimulStreaming-style)
        prefix_safety_tokens: int = 4,
        pipeline: Optional[bool] = None,
        clock: Callable[[], float] = _time.monotonic,
    ):
        self.asr = asr
        self.agreement_n = agreement_n
        self.buffer_trimming_way, self.buffer_trimming_sec = buffer_trimming
        if self.buffer_trimming_way not in ("segment", "sentence"):
            raise ValueError(f"unknown buffer_trimming way {self.buffer_trimming_way!r}")
        self.prompt_chars = prompt_chars
        self.buffer_manager = (
            DynamicBufferManager(initial_sec=self.buffer_trimming_sec) if dynamic_buffer else None
        )
        # incremental re-decode: force a stable token prefix so each tick only
        # generates new tokens. Policies:
        #   agree2 — prefix = common prefix of the last two hypotheses (safe,
        #            default; mirrors the LocalAgreement commit criterion)
        #   last   — prefix = the whole previous hypothesis minus the safety
        #            tail (aggressive; the SimulStreaming-style mode the
        #            reference's docs recommend for large models,
        #            先看这个，cursor不用看/先看这个.txt)
        self.incremental_prefix = incremental_prefix and getattr(asr, "supports_prefix", False)
        if prefix_policy not in ("agree2", "last"):
            raise ValueError(f"unknown prefix_policy {prefix_policy!r}")
        self.prefix_policy = prefix_policy
        self.prefix_safety_tokens = prefix_safety_tokens
        # software-pipelined tick loop. Two depths:
        #
        #   pipeline=True ("exact"): process_iter() finalizes + applies tick
        #   N-1, THEN dispatches tick N. The request stream is bit-identical
        #   to the synchronous loop (tick N is a function of audio ≤ N and
        #   results ≤ N-1 in both modes); only the emission of each commit
        #   moves one call later.
        #
        #   pipeline="async": process_iter() dispatches tick N FIRST — built
        #   from audio ≤ N and results ≤ N-2 — then finalizes N-1, so N-1's
        #   result copy travels while N is dispatched. The previous
        #   hypothesis, still on the card, rides as N's draft
        #   (_device_draft). Deterministic (the lag is structural, not
        #   timing-dependent) but NOT bit-identical to the sync loop —
        #   hypotheses condition on a one-tick-older prefix.
        #
        # RWA_PIPELINE=1|exact|async flips the default.
        if pipeline is None:
            env = os.environ.get("RWA_PIPELINE", "").strip().lower()
            pipeline = {"": False, "0": False, "1": True, "exact": True,
                        "async": "async"}.get(env, bool(env))
        if not hasattr(asr, "transcribe_dispatch"):
            pipeline = False
        self.pipeline = pipeline
        self._inflight: Optional[tuple[dict, float, float]] = None
        self._generation = 0  # bumped by init(); guards cross-reset handles
        self.clock = clock
        #: the ASR's device audio ring this stream's audio goes to (its
        #: prefetches and dispatches). None = the ASR's active stream
        #: (single-session use); a multi-stream caller sets a key per
        #: processor so a prefetch never lands in another stream's ring.
        self.stream_key = None
        self.init()

    # ---------------------------------------------------------------- protocol

    def init(self, offset: Optional[float] = None):
        """Reset all streaming state (session start / error recovery)."""
        # abandon any in-flight pipelined tick: its result belongs to the
        # state being wiped (its copy finishes into a buffer nobody reads)
        self._inflight = None
        self._generation = getattr(self, "_generation", 0) + 1
        self.last_apply_latency_s = 0.0
        self.audio_buffer = np.array([], dtype=np.float32)
        self.transcript_buffer = HypothesisBuffer(agreement_n=self.agreement_n)
        self.buffer_time_offset = offset if offset is not None else 0.0
        self.transcript_buffer.last_commited_time = self.buffer_time_offset
        self.commited: list[Word] = []
        self._token_history: list[list[int]] = []  # last two hypotheses' raw tokens

    def insert_audio_chunk(self, audio: np.ndarray):
        self.audio_buffer = np.append(self.audio_buffer, np.asarray(audio, np.float32))
        # upload prefetch: land the grown buffer in the device ring now,
        # between ticks, so the next tick's upload carries only the aux
        # bundle (asr.prefetch_audio)
        prefetch = getattr(self.asr, "prefetch_audio", None)
        if prefetch is not None:
            try:
                prefetch(self.audio_buffer, key=self.stream_key)
            except Exception:  # never let a prefetch break the insert path
                logger.exception("audio prefetch failed (tick upload will cover it)")

    def prompt(self) -> tuple[str, str]:
        """(prompt, non_prompt): committed text scrolled out of the buffer, cut
        to the last ``prompt_chars`` chars at a word boundary."""
        k = len(self.commited)
        while k > 0 and self.commited[k - 1][1] > self.buffer_time_offset:
            k -= 1
        non_prompt = self.asr.sep.join(t for _, _, t in self.commited[k:])
        # walk back from the scroll point only as far as prompt_chars reaches:
        # copying the whole committed transcript here made every tick O(session
        # length) — a multi-hour session paid a growing per-tick host tax
        out: list[str] = []
        length = 0
        i = k - 1
        while i >= 0 and length < self.prompt_chars:
            w = self.commited[i][2]
            length += len(w) + 1
            out.append(w)
            i -= 1
        return self.asr.sep.join(reversed(out)), non_prompt

    def process_iter(self) -> tuple[Optional[float], Optional[float], str]:
        """Re-transcribe the buffer, commit agreed words, trim, return commit."""
        with span("stream.tick"):
            return self._process_iter()

    def _process_iter(self) -> tuple[Optional[float], Optional[float], str]:
        if self.pipeline:
            return self._process_iter_pipelined()
        t_start = self.clock()
        req = self.prepare_request()
        logger.debug(
            "transcribing %.2f s from %.2f s",
            len(self.audio_buffer) / SAMPLING_RATE,
            self.buffer_time_offset,
        )
        try:
            res = self.asr.transcribe(
                req["audio"], init_prompt=req["init_prompt"],
                **({"prefix_ids": req["prefix_ids"]} if req.get("prefix_ids") else {}),
                **({"draft_ids": req["draft_ids"]} if req.get("draft_ids") else {}),
            )
        except Exception:
            # reference behavior: reset streaming state and continue
            # (enhanced_asr_processor.py:369-381)
            logger.exception("process_iter failed; resetting stream state")
            self.init(offset=self.buffer_time_offset + len(self.audio_buffer) / SAMPLING_RATE)
            return (None, None, "")
        return self.apply_result(res, self.clock() - t_start)

    def _process_iter_pipelined(self) -> tuple[Optional[float], Optional[float], str]:
        """One software-pipelined tick (see the ``pipeline`` constructor
        comment).

        exact mode: finalize + apply tick N-1, THEN dispatch tick N — applying
        the previous result before preparing this tick's request keeps the
        request stream identical to the synchronous loop, just emitted one
        call later.

        async mode: dispatch tick N FIRST (from results ≤ N-2), then finalize
        N-1."""
        if self.pipeline != "async":
            out = self._drain_inflight()
            t_start = self.clock()
            req = self.prepare_request()
            try:
                self._inflight = (
                    self.asr.transcribe_dispatch(
                        req["audio"], req["init_prompt"],
                        req.get("prefix_ids"), req.get("draft_ids"),
                        key=self.stream_key,
                    ),
                    t_start,
                    self.buffer_time_offset,
                )
            except Exception:
                # reference behavior: reset streaming state and continue
                # (enhanced_asr_processor.py:369-381)
                logger.exception("pipelined dispatch failed; resetting stream state")
                self.init(offset=self.buffer_time_offset + len(self.audio_buffer) / SAMPLING_RATE)
            return out
        # ---- async: dispatch this tick before the previous one is finalized
        gen = self._generation
        t_start = self.clock()
        req = self.prepare_request()
        st = None
        off = self.buffer_time_offset
        try:
            st = self.asr.transcribe_dispatch(
                req["audio"], req["init_prompt"],
                req.get("prefix_ids"), req.get("draft_ids"),
                key=self.stream_key,
                device_draft=self._device_draft(req),
            )
        except Exception:
            logger.exception("pipelined dispatch failed; resetting stream state")
            self.init(offset=self.buffer_time_offset + len(self.audio_buffer) / SAMPLING_RATE)
        out = self._drain_inflight()
        # a reset (dispatch failure above, or inside the drain) invalidates
        # the just-dispatched handle — its request came from pre-reset state
        if st is not None and self._generation == gen:
            self._inflight = (st, t_start, off)
        return out

    def _device_draft(self, req: dict) -> Optional[dict]:
        """Async-pipeline device-side draft: point this tick's dispatch at the
        IN-FLIGHT previous tick's sampled tokens, still on the card, so the
        prefill verify re-accepts them without the host ever seeing them
        (decode.patch_aux_device_draft). The host can only force a prefix
        from hypothesis N-2 here; without this the decode re-generates
        N-1's tokens step by step. None when there is no in-flight decode
        handle, when it was a beam search's (its packed rows are no greedy
        result), or the prefix offsets don't line up (first ticks, post-trim
        resets): the verify is lossless either way."""
        if self._inflight is None or not req.get("prefix_ids"):
            return None
        prev_st = self._inflight[0]
        h = prev_st.get("decode_handle")
        if h is None or prev_st.get("beam"):
            return None
        offset = len(req["prefix_ids"]) - len(prev_st.get("prefix_ids") or [])
        if offset < 0:
            return None
        return {
            "packed": h.packed,
            "offset": offset,
            "max_new": h.plan.max_new,
            "row_len": h.packed.numel() // h.b,
            # policy "last" forces the previous hypothesis minus the safety
            # tail (its exact sync-mode semantics, one tick fresher than the
            # host can see); agree2 stays verify-only (conservative)
            "force": self.prefix_policy == "last",
            "safety": self.prefix_safety_tokens,
        }

    def _drain_inflight(self) -> tuple[Optional[float], Optional[float], str]:
        """Finalize + apply the in-flight pipelined tick, if any."""
        if self._inflight is None:
            return (None, None, "")
        st, t_dispatch, off = self._inflight
        self._inflight = None
        try:
            res = self.asr.transcribe_finalize(st)
        except Exception:
            logger.exception("pipelined finalize failed; resetting stream state")
            self.init(offset=self.buffer_time_offset + len(self.audio_buffer) / SAMPLING_RATE)
            return (None, None, "")
        return self.apply_result(res, self.clock() - t_dispatch, time_offset=off)

    def wants_tick(self) -> bool:
        return len(self.audio_buffer) > 0

    def prepare_request(self) -> dict:
        """This tick's transcribe inputs: the buffer, the prompt, and the
        incremental-prefix and draft tokens."""
        with span("stream.prepare"):
            prompt, _ = self.prompt()
            req: dict = {"audio": self.audio_buffer, "init_prompt": prompt}
            if self.incremental_prefix:
                prefix = self._stable_prefix()
                if prefix:
                    req["prefix_ids"] = prefix
                # the last hypothesis's continuation beyond the forced prefix is
                # the self-speculative draft: the backend verifies it in the
                # prefill pass and only decodes genuinely new tokens step-by-step
                # (losslessly — rejected drafts cost nothing but the verify)
                draft = self._draft_tail(len(prefix) if prefix else 0)
                if draft:
                    req["draft_ids"] = draft
        return req

    def apply_result(self, res, proc_delay_s: float = 0.0,
                     time_offset: Optional[float] = None):
        """Finish a tick: hypothesis insert, LocalAgreement commit, trimming.

        ``time_offset`` is the buffer_time_offset the request was PREPARED at;
        it only differs from the current offset in async-pipelined mode, where
        a trim from applying tick N-1 can land between tick N's dispatch and
        its apply — the stale result's window-relative times must shift by the
        offset it was decoded against, and its token history (old-window
        timestamp tokens) is dropped so the next prefix rebuilds cleanly."""
        with span("stream.apply"):
            return self._apply_result(res, proc_delay_s, time_offset)

    def _apply_result(self, res, proc_delay_s: float, time_offset: Optional[float]):
        #: dispatch→apply span of the tick that produced the LAST applied
        #: result — in pipelined mode this is the true chunk→text latency
        #: (the per-call process_iter time only covers the drain+dispatch)
        self.last_apply_latency_s = proc_delay_s
        off = self.buffer_time_offset if time_offset is None else time_offset
        trimmed_since_dispatch = off != self.buffer_time_offset
        try:
            if self.incremental_prefix:
                toks = getattr(res, "tokens", None)
                if trimmed_since_dispatch:
                    self._token_history = []
                elif toks is not None:
                    self._token_history = (self._token_history + [list(toks)])[-2:]
            tsw = self.asr.ts_words(res)
            self.transcript_buffer.insert(tsw, off)
            o = self.transcript_buffer.flush()
            self.commited.extend(o)
        except Exception:
            logger.exception("apply_result failed; resetting stream state")
            self.init(offset=self.buffer_time_offset + len(self.audio_buffer) / SAMPLING_RATE)
            return (None, None, "")

        trim_sec = self.buffer_trimming_sec
        if self.buffer_manager is not None:
            trim_sec = self.buffer_manager.adjust(proc_delay_s)
        if len(self.audio_buffer) / SAMPLING_RATE > trim_sec:
            if self.buffer_trimming_way == "sentence":
                self.chunk_completed_sentence()
            else:
                self.chunk_completed_segment(res, time_offset=off)
        return self.to_flush(o)

    def finish_all(self) -> list[tuple[Optional[float], Optional[float], str]]:
        """The drain protocol of ``VACOnlineASRProcessor.finish_all``: this
        processor stages no utterances, so one flush."""
        ret = self.finish()
        return [ret] if ret[2] else []

    def finish(self) -> tuple[Optional[float], Optional[float], str]:
        """Flush the uncommitted tail at stream end."""
        # pipelined mode: the last dispatched tick's commit hasn't been
        # returned yet — apply it first so the tail flush below sees it, and
        # merge its committed text into the return (they're contiguous)
        head = self._drain_inflight() if self._inflight is not None else (None, None, "")
        o = self.transcript_buffer.complete()
        f = self.to_flush(o)
        logger.debug("final non-committed: %s", f)
        # clear the flushed tail so a second finish() (utterance-end inside VAC
        # followed by session-end, reference 一键…py:1887) can't duplicate it
        self.commited.extend(o)
        self.transcript_buffer.buffer = []
        self.buffer_time_offset += len(self.audio_buffer) / SAMPLING_RATE
        self.audio_buffer = np.array([], dtype=np.float32)
        if head[2]:
            f = (head[0], f[1] if f[1] is not None else head[1],
                 (head[2] + self.asr.sep + f[2]) if f[2] else head[2])
        return f

    # ---------------------------------------------------------------- trimming

    #: sentence-final punctuation (latin + CJK full-width) for sentence trimming
    _SENTENCE_END = (".", "!", "?", "。", "！", "？", "…")

    def words_to_sentences(self, words: list[Word]) -> list[Word]:
        """Group committed words into (beg, end, text) sentences with a
        lightweight punctuation splitter (the whisper_online contract uses an
        external sentence tokenizer here; SURVEY.md §2.2 OnlineASRProcessor
        row — this is the dependency-free equivalent, CJK-aware)."""
        sentences: list[Word] = []
        cur: list[Word] = []
        for w in words:
            cur.append(w)
            if w[2].rstrip().endswith(self._SENTENCE_END):
                sentences.append(
                    (cur[0][0], cur[-1][1], self.asr.sep.join(t for _, _, t in cur))
                )
                cur = []
        if cur:
            sentences.append((cur[0][0], cur[-1][1], self.asr.sep.join(t for _, _, t in cur)))
        return sentences

    def chunk_completed_sentence(self) -> None:
        """Trim at the end of the second-to-last committed sentence, keeping
        the (possibly still growing) last sentence in the buffer."""
        if not self.commited:
            return
        # only words still inside the buffer window matter: a trim point at or
        # before buffer_time_offset is a no-op in chunk_at, sentence-END times
        # in the tail are identical either way (boundaries are per-word
        # punctuation), and scanning the full transcript made every trim
        # O(session length)
        j = len(self.commited)
        while j > 0 and self.commited[j - 1][1] > self.buffer_time_offset:
            j -= 1
        sentences = self.words_to_sentences(self.commited[j:])
        if len(sentences) < 2:
            logger.debug("--- not enough completed sentences to trim")
            return
        self.chunk_at(sentences[-2][1])

    def chunk_completed_segment(self, res, time_offset: Optional[float] = None) -> None:
        """Trim at the last completed-segment boundary before the last commit.
        ``time_offset``: the offset ``res`` was decoded against (async-pipelined
        staleness — see apply_result); defaults to the current offset."""
        if not self.commited:
            return
        off = self.buffer_time_offset if time_offset is None else time_offset
        ends = self.asr.segments_end_ts(res)
        t = self.commited[-1][1]
        if len(ends) > 1:
            e = ends[-2] + off
            while len(ends) > 2 and e > t:
                ends.pop(-1)
                e = ends[-2] + off
            if e <= t:
                self.chunk_at(e)
                return
        logger.debug("--- last segment not within committed area")

    def chunk_at(self, time: float) -> None:
        self.transcript_buffer.pop_commited(time)
        cut_seconds = time - self.buffer_time_offset
        if cut_seconds <= 0:
            return
        self.audio_buffer = self.audio_buffer[int(cut_seconds * SAMPLING_RATE) :]
        self.buffer_time_offset = time
        self._shift_token_history(cut_seconds)
        logger.debug("chunked at %.2f s", time)

    def _shift_token_history(self, cut_seconds: float) -> None:
        """Re-base hypothesis tokens after a trim so the incremental prefix
        survives: trims land exactly on decoded segment-end timestamps, so
        dropping tokens before the cut and shifting timestamp tokens by
        −cut/0.02 realigns them with the new buffer origin. Any mismatch
        (no exact boundary) clears the history instead."""
        cfg = getattr(self.asr, "cfg", None)
        if cfg is None or not self._token_history:
            self._token_history = []
            return
        ts0 = cfg.timestamp_begin
        delta_f = cut_seconds / 0.02
        delta = int(round(delta_f))
        if abs(delta_f - delta) > 1e-3:
            self._token_history = []
            return
        shifted: list[list[int]] = []
        for seq in self._token_history:
            idx = next(
                (i for i, t in enumerate(seq) if t >= ts0 and t - ts0 >= delta), None
            )
            if idx is None:
                self._token_history = []  # cut beyond this hypothesis
                return
            if idx + 1 < len(seq) and seq[idx + 1] >= ts0:
                idx += 1  # idx was the closing timestamp of a straddling segment
            shifted.append([(t - delta) if t >= ts0 else t for t in seq[idx:]])
        self._token_history = shifted

    def _stable_prefix(self) -> list[int]:
        """Token prefix to force, per prefix_policy, minus a safety tail."""
        if self.prefix_policy == "last":
            if not self._token_history:
                return []
            a = self._token_history[-1]
            return a[: max(0, len(a) - self.prefix_safety_tokens)]
        if len(self._token_history) < 2:
            return []
        a, b = self._token_history[-2], self._token_history[-1]
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return a[: max(0, n - self.prefix_safety_tokens)]

    def _draft_tail(self, n_prefix: int) -> list[int]:
        """Last hypothesis's tokens beyond the forced prefix — the
        self-speculative draft. Capped at the backend's draft bucket (the
        backend truncates anyway; keep the request small)."""
        if not self._token_history:
            return []
        tail = self._token_history[-1][n_prefix:]
        return tail[:16]

    # ----------------------------------------------------------------- helpers

    def set_pipeline(self, mode) -> tuple[Optional[float], Optional[float], str]:
        """Switch tick-loop pipelining (False | True/"exact" | "async") at
        runtime. Any in-flight tick is drained first so the switch is safe
        mid-session; the drained commit (if any) is returned so the caller
        can emit it."""
        mode = {False: False, "": False, "0": False, 0: False, True: True,
                "1": True, 1: True, "exact": True, "async": "async"}.get(mode, bool(mode))
        if mode and not hasattr(self.asr, "transcribe_dispatch"):
            mode = False
        out = (None, None, "")
        if self._inflight is not None and mode != self.pipeline:
            out = self._drain_inflight()
        self.pipeline = mode
        return out

    def set_agreement_n(self, n: int) -> None:
        self.agreement_n = n
        self.transcript_buffer.set_agreement_n(n)

    def to_flush(self, words: list[Word]) -> tuple[Optional[float], Optional[float], str]:
        if not words:
            return (None, None, "")
        text = self.asr.sep.join(t for _, _, t in words)
        return (words[0][0], words[-1][1], text)

    # --------------------------------------------------------- checkpointing

    def state_dict(self) -> dict:
        """Serializable streaming state (SURVEY.md §5 checkpoint/resume)."""
        if self._inflight is not None:
            # settle the pipelined tick so the snapshot captures its commit
            # (a resumed session can't fetch this process's device handle)
            self._drain_inflight()
        tb = self.transcript_buffer
        return {
            "audio_buffer": self.audio_buffer.copy(),
            "buffer_time_offset": self.buffer_time_offset,
            "commited": list(self.commited),
            "hb_commited_in_buffer": list(tb.commited_in_buffer),
            "hb_buffer": list(tb.buffer),
            "hb_history": [list(h) for h in tb.history],
            "hb_last_commited_time": tb.last_commited_time,
            "hb_last_commited_word": tb.last_commited_word,
            "agreement_n": self.agreement_n,
        }

    def load_state_dict(self, state: dict) -> None:
        self.init()
        self.audio_buffer = np.asarray(state["audio_buffer"], np.float32)
        self.buffer_time_offset = state["buffer_time_offset"]
        self.commited = [tuple(w) for w in state["commited"]]
        tb = self.transcript_buffer
        tb.commited_in_buffer = [tuple(w) for w in state["hb_commited_in_buffer"]]
        tb.buffer = [tuple(w) for w in state["hb_buffer"]]
        for h in state["hb_history"]:
            tb.history.append([tuple(w) for w in h])
        tb.last_commited_time = state["hb_last_commited_time"]
        tb.last_commited_word = state["hb_last_commited_word"]
        self.set_agreement_n(state["agreement_n"])
