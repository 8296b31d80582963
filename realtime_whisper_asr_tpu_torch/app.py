"""Session orchestration: the realtime loop.

Port of ``realtime_whisper_asr_tpu/app.py``. ``StreamingApp`` wires the full
stage pipeline per config — vocal separation (on the host one chunk ahead,
or fused into the encode on the card) → audio-dedup gate → VAC/online
processor → timestamp validation → skip detector → speech-rate adaptation
(silence controller, time stretch, adaptive decode params) → speaker labels
→ sinks (async console, translation, CSV log, performance monitor and
display) — around an injectable ASR backend and audio stream, mirroring the
reference's record_session (`一键实时识别麦克风.py:1247-1959`) and session
loop (:2184-2396) with language hot-swap.

Deliberate difference: no degraded mode. Where the JAX app, finding no
accelerator, falls back to a smaller model on the CPU, this one takes
``device`` (default ``"cuda"``) through ``device.resolve_device``: it raises
on a host without CUDA, and runs the configured model on the CPU only when
asked for ``device="cpu"``. The JAX package's idle keep-alive is not ported
(the ``hasattr`` guard in ``record_session`` skips it).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.config import ConfigManager
from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.io.protector import AudioDeviceProtector
from realtime_whisper_asr_tpu_torch.pipeline import (
    AudioDeduplicator,
    SkipDetector,
    SpeechRateAdaptiveProcessor,
    create_separator,
)
from realtime_whisper_asr_tpu_torch.services import (
    AsyncOutput,
    LogManager,
    PerformanceDisplay,
    PerformanceMonitor,
    TranslationManager,
)
from realtime_whisper_asr_tpu_torch.streaming import (
    OnlineASRProcessor,
    VACOnlineASRProcessor,
    VADIterator,
)

logger = logging.getLogger(__name__)

SR = 16000


def validate_timestamps(beg, end, text: str) -> bool:
    """Result sanity rules (reference 一键…py:1524-1541): drop end<beg; drop
    zero-length results with suspiciously long text."""
    if beg is None or end is None:
        return False
    if end < beg:
        return False
    if end == beg and len(text) > 50:
        return False
    return True


class _OneAheadWorker:
    """One-slot read-ahead pipeline on a DAEMON thread.

    ``submit()`` queues one run of ``fn``; ``result()`` blocks for its return
    value (re-raising any exception in the caller, like ``Future.result``).
    The thread is daemonic so a body blocked forever in a device read cannot
    hang interpreter exit — the failure mode ThreadPoolExecutor has (its
    exit hook joins non-daemon workers without timeout). ``fn`` runs under
    the thread's own ``torch.inference_mode`` (the mode is per thread); its
    card work joins the default stream in launch order."""

    def __init__(self, fn: Callable, name: str = "worker"):
        import queue
        import threading

        self._fn = fn
        self._req: "queue.SimpleQueue" = queue.SimpleQueue()
        self._res: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    @torch.inference_mode()
    def _run(self):
        while self._req.get():
            try:
                self._res.put((True, self._fn()))
            except BaseException as e:  # delivered to result(), like a Future
                self._res.put((False, e))

    def submit(self) -> None:
        self._req.put(True)

    def result(self):
        ok, value = self._res.get()
        if not ok:
            raise value
        return value

    def stop(self) -> None:
        """Ask the worker to exit after any in-flight run; never blocks. An
        in-flight blocking read just dies with the process (daemon)."""
        self._req.put(False)


class AutoLanguageController:
    """Auto-language streaming: re-detect language at utterance boundaries and
    hot-swap per-language config when it changes.

    The reference supports only a MANUAL language change between sessions
    (`一键实时识别麦克风.py:2194-2347`, full ASR/processor rebuild); this
    automates it: each utterance end (VAC voice→nonvoice) runs
    ``asr.detect_language`` on the utterance's audio, and after ``consecutive``
    agreeing detections of a different language with p ≥ ``min_prob`` the app
    is switched via ``change_language`` (which re-applies per-language vad/
    streaming/skip overrides and re-inits the processor — safe at an utterance
    boundary because the hypothesis was just flushed).
    """

    def __init__(self, app: "StreamingApp", min_prob: float = 0.5,
                 consecutive: int = 2, min_audio_s: float = 1.0,
                 max_audio_s: float = 8.0):
        self.app = app
        self.min_prob = min_prob
        self.consecutive = consecutive
        self.min_samples = int(min_audio_s * SR)
        self.max_samples = int(max_audio_s * SR)
        self._ring = np.zeros(0, np.float32)
        self._utterance_samples = 0
        self._candidate: Optional[str] = None
        self._votes = 0
        self.switches = 0
        self.detections = 0

    def observe_chunk(self, chunk: np.ndarray, voiced: bool) -> None:
        """Track the current utterance's audio (bounded ring)."""
        if voiced:
            self._ring = np.append(self._ring, chunk)[-self.max_samples :]
            self._utterance_samples += len(chunk)
        # silence chunks don't reset: the ring holds the last utterance until
        # the boundary fires

    def on_utterance_end(self) -> Optional[str]:
        """Detect on the finished utterance; switch after enough agreement.

        Returns the new language when a switch happened, else None.
        """
        audio, self._ring = self._ring, np.zeros(0, np.float32)
        n = self._utterance_samples
        self._utterance_samples = 0
        if min(len(audio), n) < self.min_samples:
            return None
        try:
            lang, prob = self.app.asr.detect_language(audio)
        except Exception:
            logger.exception("language detection failed; keeping %s", self.app.language)
            return None
        self.detections += 1
        if prob < self.min_prob or lang == self.app.language:
            self._candidate, self._votes = None, 0
            return None
        if lang == self._candidate:
            self._votes += 1
        else:
            self._candidate, self._votes = lang, 1
        if self._votes >= self.consecutive:
            self._candidate, self._votes = None, 0
            logger.info("auto-language: %s confirmed (p=%.2f); switch scheduled", lang, prob)
            return lang  # the app performs the switch at a safe boundary
        return None

    def get_stats(self) -> dict:
        return {"detections": self.detections, "switches": self.switches}


@dataclasses.dataclass
class SessionStats:
    results: int = 0
    skipped: int = 0
    chunks: int = 0
    dedup_skipped: int = 0
    duration_s: float = 0.0
    recoveries: int = 0


class StreamingApp:
    def __init__(
        self,
        config: Optional[ConfigManager] = None,
        asr=None,
        language: Optional[str] = None,
        task: str = "transcribe",
        vad_prob_fn: Optional[Callable] = None,
        output: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
    ):
        """``device``: where the ASR (when ``asr`` is None), the Silero-like
        VAD, the separators and the time stretch run; the card unless asked
        otherwise, and it raises when CUDA is absent."""
        self.device = resolve_device(device)
        self.cm = config or ConfigManager(autoload=False)
        self.language = language
        self.task = task
        self.clock = clock
        cfg = self.cm.get_language_specific_config(language) if language else dict(self.cm.config)
        cfg.pop("language_specific", None)
        self.cfg = cfg

        # --- ASR backend (injectable for tests) ---
        if asr is None:
            from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR

            m = cfg["model"]
            asr = TorchWhisperASR(
                model_size=m["size"],
                language=language,
                checkpoint_dir=m.get("checkpoint_dir"),
                dtype=torch.bfloat16 if m.get("dtype") == "bfloat16" else torch.float32,
                quantization=m.get("quantization"),
                beam_size=m.get("beam_size", 1),
                word_timestamps=m.get("word_timestamps", True),
                device=self.device,
            )
            if task == "translate":
                asr.set_translate_task()
            if m.get("max_tokens_per_second") is not None:
                asr.max_tokens_per_second = float(m["max_tokens_per_second"])
        self.asr = asr

        # --- streaming processor ---
        s = cfg["streaming"]
        online = OnlineASRProcessor(
            asr,
            agreement_n=s["agreement_n"],
            prefix_policy=s.get("prefix_policy", "agree2"),
            buffer_trimming=(s.get("buffer_trimming_way", "segment"), s["buffer_trimming_sec"]),
            prompt_chars=s["prompt_chars"],
            dynamic_buffer=s["dynamic_buffer"],
            pipeline=s.get("pipeline"),
            clock=clock,
        )
        self.online = online  # inner tick loop (processor may be the VAC wrap)
        #: streaming.pipeline=None (+ no RWA_PIPELINE env) = auto: the session
        #: loop picks per feed pacing — async pipelined ticks for as-fast
        #: feeds (file transcription, catch-up, scenario benches: the fetch's
        #: round trip overlaps the next tick's device compute), synchronous
        #: ticks for realtime-paced mics (idle between chunks; sync minimizes
        #: per-chunk latency). An explicit config/env value wins.
        self._pipeline_auto = (
            s.get("pipeline") is None and not os.environ.get("RWA_PIPELINE")
        )
        v = cfg["vad"]
        if v["enable"]:
            if vad_prob_fn is None:
                if v.get("backend", "silero_like") == "silero_like":
                    from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD

                    cand = SileroLikeVAD(device=self.device)
                    if cand.trained:
                        vad_prob_fn = cand
                    else:
                        logger.warning(
                            "silero_like weights missing; falling back to EnergyVAD"
                        )
                if vad_prob_fn is None:
                    from realtime_whisper_asr_tpu_torch.models.vad import EnergyVAD

                    vad_prob_fn = EnergyVAD()
            self.processor = VACOnlineASRProcessor(
                online,
                VADIterator(
                    vad_prob_fn,
                    threshold=v["threshold"],
                    min_silence_duration_ms=v["min_silence_duration_ms"],
                    speech_pad_ms=v["speech_pad_ms"],
                ),
                online_chunk_size=s["online_chunk_size"],
            )
        else:
            self.processor = online
        self.min_chunk_seconds = s.get("min_chunk_seconds", 1.0)
        self._since_process = 0  # samples since the last non-VAC process_iter

        # --- pipeline stages ---
        sep_cfg = cfg["vocal_separation"]
        self.separator = (
            create_separator(
                sep_cfg["method"],
                **{k: v for k, v in sep_cfg.items() if k not in ("enable", "method")},
                device=self.device,
            )
            if sep_cfg["enable"]
            else None
        )
        #: fused separation (the default for a trained neural net): the mask
        #: net runs on each encoded window on the card, before K1, instead of
        #: per chunk in the host loop (the reference's ordering,
        #: 一键实时识别麦克风.py:1474-1482) — no host conv cost, no extra
        #: copies, no chunk-boundary STFT artifacts. Trade-off: host
        #: stages that read raw audio (VAD gate, dedup features) see the
        #: unseparated signal; set vocal_separation.fuse_encode=false for the
        #: reference's separate-before-everything order.
        self.fused_separation = False
        if (
            self.separator is not None
            and sep_cfg.get("fuse_encode", True)
            and getattr(self.separator, "name", "") == "neural"
            and getattr(self.separator, "trained", False)
            and hasattr(self.asr, "set_separation_frontend")
        ):
            self.asr.set_separation_frontend(self.separator.params)
            self.fused_separation = True
            self.separator = None  # the hot loop must not separate twice
        dd = cfg["audio_deduplication"]
        self.deduplicator = (
            AudioDeduplicator(
                similarity_threshold=dd["similarity_threshold"],
                duplicate_threshold=dd["duplicate_threshold"],
                time_window_s=dd["time_window_s"],
                history_size=dd["history_size"],
                device=self.device,
            )
            if dd["enable"]
            else None
        )
        sk = cfg["skip_detector"]
        self.skip_detector = (
            SkipDetector(
                similarity_threshold=sk["similarity_threshold"],
                time_window_s=sk["time_window_s"],
                min_length=sk["min_length"],
                containment_threshold=sk["containment_threshold"],
            )
            if sk["enable"]
            else None
        )
        ra = cfg["speech_rate_adaptive"]
        self.rate_adaptive = (
            SpeechRateAdaptiveProcessor(
                self.processor,
                update_interval_s=ra["update_interval_s"],
                slow_cps=ra.get("slow_cps", 5.0),
                fast_cps=ra.get("fast_cps", 15.0),
                initial_ms=ra["initial_silence_ms"],
                min_ms=ra["min_silence_ms"],
                max_ms=ra["max_silence_ms"],
                step_ms=ra["step_ms"],
                # one timebase: on_result is fed this clock's 'now' as sample
                # stamps; the default time.time would make read-time expiry
                # compare monotonic stamps against wall time
                clock=self.clock,
            )
            if ra["enable"] and cfg["vad"]["enable"]
            else None
        )
        # asr_optimization: time-stretch normalization + adaptive decode
        # params by measured speech rate (the reference defines the module
        # but never constructs it in main(); both knobs are opt-in). NOTE:
        # stretching changes the audio timeline, so while it is active the
        # emitted timestamps refer to normalized (stretched) time.
        ao = cfg.get("asr_optimization", {})
        self.stretch_processor = None
        if ao.get("time_stretch_enable"):
            from realtime_whisper_asr_tpu_torch.pipeline.stretch import SpeechRateAudioProcessor

            self.stretch_processor = SpeechRateAudioProcessor(
                normal_cps=ao.get("normal_cps", 10.0), device=self.device
            )
        if ao.get("adaptive_params_enable"):
            from realtime_whisper_asr_tpu_torch.pipeline.stretch import AdaptiveWhisperParams

            params = AdaptiveWhisperParams(
                base_beam_size=cfg["model"].get("beam_size", 1) or 1
            )
            params.rate_class = "normal"
            self.asr.adaptive_params = params
        # both knobs need a chars/sec source; reuse the adaptive-silence
        # detector when enabled, else keep a standalone one fed on results
        self._rate_detector = None
        if self.stretch_processor is not None or ao.get("adaptive_params_enable"):
            if self.rate_adaptive is not None:
                self._rate_detector = self.rate_adaptive.detector
            else:
                from realtime_whisper_asr_tpu_torch.pipeline.speech_rate import SpeechRateDetector

                self._rate_detector = SpeechRateDetector(clock=self.clock)

        # --- services ---
        self.output = AsyncOutput(write=output) if output else AsyncOutput()
        tr = cfg["translation"]
        self.translation = None
        if tr["enable"] and task == "transcribe":
            self.translation = TranslationManager(
                output_callback=lambda src, t: self.output.print(f"🌐 {t}"),
                translate_interval=tr["interval_s"],
                target_language=tr["target_language"],
            )
            self.translation.start()
        ld = cfg.get("language_detection", {"enable": False})
        self.auto_language = None
        self._pending_lang_switch: Optional[str] = None
        self._prev_vac_status: Optional[str] = None
        self._prev_utt_ends = 0  # consumed VAC end-event count
        if (
            ld.get("enable")
            and cfg["vad"]["enable"]
            and hasattr(self.asr, "detect_language")
        ):
            self.auto_language = AutoLanguageController(
                self,
                min_prob=ld.get("min_prob", 0.5),
                consecutive=ld.get("consecutive", 2),
                min_audio_s=ld.get("min_audio_s", 1.0),
                max_audio_s=ld.get("max_audio_s", 8.0),
            )

        di = cfg.get("diarization", {"enable": False})
        self.diarizer = None
        if di.get("enable") and cfg["vad"]["enable"]:
            from realtime_whisper_asr_tpu_torch.models.speaker import (
                SpeakerTracker,
                SpeakerTurnController,
            )

            self.diarizer = SpeakerTurnController(
                SpeakerTracker(
                    threshold=di.get("threshold"),
                    max_speakers=di.get("max_speakers", 8),
                ),
                min_audio_s=di.get("min_audio_s", 0.6),
                max_audio_s=di.get("max_audio_s", 10.0),
            )
        self._label_results = bool(di.get("label_results", True))

        perf = cfg["performance"]
        self.monitor = (
            PerformanceMonitor(hard_ratio=perf.get("hard_ratio", 0.4),
                               soft_ratio=perf.get("soft_ratio", 0.6))
            if perf["monitor_enable"]
            else None
        )
        self.display = PerformanceDisplay(interval_s=cfg["performance"]["display_interval_s"])
        lg = cfg["logging"]
        self.log_manager = (
            LogManager(log_dir=lg["dir"], console=lg["console_log_enabled"]) if lg["enable"] else None
        )

    # ---------------------------------------------------------------- session

    def _lang_switch_safe(self) -> bool:
        """A language hot-swap re-inits the processor; only do it at a true
        utterance boundary (no active voice, no unflushed final, no staged
        utterance)."""
        return (
            getattr(self.processor, "status", None) != "voice"
            and not getattr(self.processor, "is_currently_final", False)
            and not getattr(self.processor, "_pending", None)
        )

    def process_chunk(self, chunk: np.ndarray, stats: SessionStats, now: float,
                      separated: bool = False) -> Optional[str]:
        """One hot-loop iteration body (reference 一键…py:1444-1677).

        ``separated=True`` marks a chunk the pipelined session loop already
        ran through the vocal separator (record_session overlaps the next
        chunk's separation with this tick's device wait)."""
        stats.chunks += 1
        if self._pending_lang_switch is not None and self._lang_switch_safe():
            self.change_language(self._pending_lang_switch)
            self._pending_lang_switch = None
            if self.auto_language is not None:
                self.auto_language.switches += 1
        if self.separator is not None and not separated:
            chunk = self.separator.separate(chunk)
        if self.deduplicator is not None:
            skip, _ = self.deduplicator.should_skip(chunk, now)
            if skip:
                stats.dedup_skipped += 1
                return None
        if self.stretch_processor is not None and self._rate_detector is not None:
            # asr_optimization.time_stretch_enable: normalize the speech rate
            # before the processor sees the audio (timestamps then refer to
            # the normalized timeline — documented at the config knob)
            chunk = self.stretch_processor.process(
                chunk, self._rate_detector.chars_per_second()
            )
        self.processor.insert_audio_chunk(chunk)
        if self.auto_language is not None or self.diarizer is not None:
            status = getattr(self.processor, "status", None)
            voiced = status == "voice"
            if self.auto_language is not None:
                self.auto_language.observe_chunk(chunk, voiced=voiced)
            if self.diarizer is not None:
                self.diarizer.observe_chunk(chunk, voiced=voiced)
            # count VAC end EVENTS where available: the before/after status
            # compare misses an end+start pair inside one chunk (status stays
            # 'voice' across the boundary); counter below the watermark =
            # processor re-init (error reset) — resync without inventing ends
            ends = getattr(self.processor, "utterance_ends", None)
            if ends is not None:
                if ends < self._prev_utt_ends:
                    self._prev_utt_ends = ends
                n_ends = ends - self._prev_utt_ends
                self._prev_utt_ends = ends
            else:
                n_ends = 1 if (self._prev_vac_status == "voice"
                               and status == "nonvoice") else 0
            for _ in range(n_ends):
                if self.auto_language is not None:
                    lang = self.auto_language.on_utterance_end()
                    if lang is not None:
                        self._pending_lang_switch = lang
                if self.diarizer is not None:
                    ev = self.diarizer.on_utterance_end()
                    if ev is not None and ev[1]:
                        self.output.print(f"🗣 speaker {self.diarizer.current_label}")
            self._prev_vac_status = status
        # non-VAC mode throttles full re-transcriptions to min_chunk_seconds
        # (reference chunk_duration gating, 一键…py:1679-1876); VAC gates itself
        if not hasattr(self.processor, "set_silence_duration"):
            self._since_process += len(chunk)
            if self._since_process < self.min_chunk_seconds * SR:
                return None
            self._since_process = 0
        t0 = self.clock()
        beg, end, text = self.processor.process_iter()
        proc_s = self.clock() - t0
        if not text:
            return None
        if getattr(self.online, "pipeline", False):
            # pipelined ticks: the per-call span only covers drain+dispatch;
            # the true chunk→text latency of the tick that PRODUCED this text
            # is its dispatch→apply span (same accounting as bench.py)
            proc_s = self.online.last_apply_latency_s or proc_s
        if self.monitor is not None and beg is not None and end is not None:
            self.monitor.record_recognition(max(end - beg, 1e-3), max(proc_s, 1e-6))
        if not validate_timestamps(beg, end, text):
            logger.debug("dropping invalid timestamps: %.2f-%.2f %r", beg, end, text)
            return None
        if self.skip_detector is not None:
            skip, reason = self.skip_detector.should_skip(text, now)
            if skip:
                stats.skipped += 1
                if self.log_manager:
                    self.log_manager.log_skip(text, reason)
                return None
        stats.results += 1
        # live_label = provisional classification of the utterance in
        # progress, so the printed [S<n>] matches THIS result's utterance
        # instead of trailing one utterance behind
        live = self.diarizer.live_label() if self.diarizer is not None else None
        label = f"[{live}] " if self._label_results and live else ""
        self.output.print(f"💬 {label}{text}")
        if self.log_manager:
            self.log_manager.log_recognition(beg, end, text, latency_ms=proc_s * 1e3,
                                             language=self.language or "", model="")
        if self.translation is not None:
            self.translation.add_text(text)
        # when time-stretch is active the processor's timestamps live in the
        # NORMALIZED timeline; multiply result durations back by the applied
        # rate so the detector measures the speaker's raw rate — feeding it
        # post-stretch durations measures the vocoder's own output and the
        # correction cancels itself into chunk-to-chunk oscillation
        raw_scale = (self.stretch_processor.applied_rate
                     if self.stretch_processor is not None else 1.0)
        if self.rate_adaptive is not None:
            self.rate_adaptive.on_result(
                text, beg, beg + (end - beg) * raw_scale, now)
        elif self._rate_detector is not None:
            # standalone cps source for asr_optimization (no adaptive silence)
            self._rate_detector.add_result(
                text, max((end - beg) * raw_scale, 1e-3), now)
        if self.asr is not None and getattr(self.asr, "adaptive_params", None) is not None \
                and self._rate_detector is not None:
            self.asr.adaptive_params.rate_class = self._rate_detector.classify()
        return text

    def record_session(
        self,
        stream,
        chunk_seconds: float = 0.25,
        max_seconds: Optional[float] = None,
        until_exhausted: bool = True,
        use_protector: bool = True,
    ) -> SessionStats:
        """Run the realtime loop over a stream (mic or simulated).

        Stops on stream exhaustion (simulated), max_seconds, or Ctrl+C —
        always flushing the final hypothesis (reference 一键…py:1878-1959).
        """
        stats = SessionStats()
        protector = None
        if use_protector:
            if callable(stream):  # true factory (e.g. reopens a mic device)
                factory = stream
                stream = factory()
            else:
                src = stream

                def factory():
                    if getattr(src, "closed", False) and hasattr(src, "reopen"):
                        src.reopen()
                    return src

            protector = AudioDeviceProtector(factory, max_retries=3, retry_delay_s=0.1)
            protector.stream = stream
            protector.healthy = True
        n = int(chunk_seconds * SR)
        fed = 0.0
        # pipeline auto-select per feed pacing (streaming.pipeline=None):
        # an as-fast feed (SimulatedMicStream realtime=False — file
        # transcription, catch-up replay, the scenario benches) runs the
        # async software-pipelined tick loop so the result fetch's round trip
        # overlaps the next tick's device compute; a realtime-paced source (a
        # real mic, or a simulated one with realtime=True) keeps synchronous
        # ticks for minimal per-chunk latency. The hot loop the reference
        # models here is 一键实时识别麦克风.py:1444-1677.
        restore_pipeline = None
        if self._pipeline_auto and not getattr(stream, "realtime", True):
            restore_pipeline = self.online.pipeline
            # beam sessions pipeline in "exact" mode: same download/compute
            # overlap, commits token-identical to the sync loop. async's
            # one-tick-staler conditioning has no device draft in beam mode
            # (online._device_draft guards it out), and beam's re-searched
            # hypotheses under that staleness suppress agreement commits —
            # measured round 5 on-rig: beam-5 async committed 0 results in
            # 72 ticks where the sync loop commits 54. Beam is the quality
            # knob; it gets the quality-locked pipelined mode.
            beam = getattr(self.asr, "beam_size", 1) or 1
            self.online.set_pipeline("exact" if beam > 1 else "async")
        #: tick-loop mode THIS session ran under (bench/observability; the
        #: configured mode is restored on exit when auto-select engaged)
        self.last_session_pipeline = self.online.pipeline
        # anchor the idle indicator at session start — a getattr default of
        # "now" re-evaluated every iteration could never age past the 2 s
        # gate, so a session that STARTS silent showed no heartbeat at all
        self._last_text_time = self.clock()

        def _read_and_separate():
            """Worker body: blocking read + vocal separation. Run one chunk
            ahead on a worker thread when separation is enabled, so the
            separator's work overlaps the previous tick's device wait instead
            of serializing in front of it (the reference gets the same
            overlap from its mic-loop/processing thread split,
            一键…py:432-509)."""
            if protector is not None:
                chunk, recovered = protector.read_audio(n)
            else:
                chunk, _ = stream.read(n)
                recovered = False
            sep = chunk
            if self.separator is not None:
                sep = self.separator.separate(chunk)
            return chunk, sep, recovered

        # the JAX backend's idle keep-alive (not ported: the guard skips it)
        if self.asr is not None and hasattr(self.asr, "start_idle_keepalive"):
            self.asr.start_idle_keepalive()
        worker = None
        pending = False
        if self.separator is not None:
            # NOT a ThreadPoolExecutor: its threads are non-daemon and the
            # interpreter-exit hook joins them without timeout, so a worker
            # blocked forever in stream.read() (dead mic) would hang process
            # exit after Ctrl-C. A daemon thread with the same one-slot
            # pipeline semantics dies with the process instead.
            worker = _OneAheadWorker(_read_and_separate, name="read-sep")
        try:
            while True:
                if max_seconds is not None and fed >= max_seconds:
                    break
                if not pending and until_exhausted and getattr(stream, "exhausted", False):
                    break
                if worker is not None:
                    if not pending:
                        worker.submit()
                    pending = False
                    chunk, sep_chunk, recovered = worker.result()
                else:
                    chunk, sep_chunk, recovered = _read_and_separate()
                if recovered:
                    stats.recoveries += 1
                    if protector is not None:
                        stream = protector.stream  # recovery may install a new stream
                fed += len(chunk) / SR
                # pre-submit the NEXT read+separate before this tick's device
                # work, unless this session is already at its last chunk
                if worker is not None and (
                    (max_seconds is None or fed < max_seconds)
                    and not (until_exhausted and getattr(stream, "exhausted", False))
                ):
                    worker.submit()
                    pending = True
                text = self.process_chunk(sep_chunk, stats, self.clock(), separated=True)
                # idle UI: blinking nonvoice marker + heartbeat (reference
                # 一键…py:1653-1677) — only on a TTY, throttled
                if text:
                    self._last_text_time = self.clock()
                elif (
                    self.display.color_enabled
                    and self.clock() - getattr(self, "_last_text_time", self.clock()) > 2.0
                    and getattr(self.processor, "status", None) != "voice"
                ):
                    blink = "🔇 nonvoice" if int(self.clock() * 2) % 2 == 0 else "          "
                    print(f"\r{blink}", end="", flush=True)
                if self.monitor is not None:
                    self.display.display_stats(
                        monitor=self.monitor,
                        skip_stats=self.skip_detector.get_stats() if self.skip_detector else None,
                        dedup_stats=self.deduplicator.get_stats() if self.deduplicator else None,
                        device_status=protector.get_status() if protector else None,
                    )
        except KeyboardInterrupt:
            logger.info("interrupted; flushing")
        finally:
            if worker is not None:
                worker.stop()
            if self.asr is not None and hasattr(self.asr, "stop_idle_keepalive"):
                self.asr.stop_idle_keepalive()
            # finish_all: one finish() hands over only ONE staged VAC
            # utterance (end+start inside the final chunk) — a single call
            # here silently dropped the rest (round-3 review; the serving
            # close path already drained)
            if hasattr(self.processor, "finish_all"):
                finishes = self.processor.finish_all()
            else:
                finishes = [self.processor.finish()]
            for beg, end, text in finishes:
                if not (text and validate_timestamps(beg, end, text)):
                    continue
                skip = False
                if self.skip_detector is not None:
                    skip, _ = self.skip_detector.should_skip(text, self.clock())
                if not skip:
                    stats.results += 1
                    self.output.print(f"💬 {text}")
                    if self.translation is not None:
                        self.translation.add_text(text)
            if restore_pipeline is not None:
                # finish_all above drained any in-flight tick; restore the
                # configured (auto) mode for the next session's feed
                self.online.set_pipeline(restore_pipeline)
            stats.duration_s = fed
        return stats

    # ------------------------------------------------------------ hot reload

    def change_language(self, language: str):
        """Language hot-swap (reference :2194-2347): re-resolve per-language
        config and rebuild the streaming state; model weights are reused."""
        self.language = language
        if hasattr(self.asr, "original_language"):
            self.asr.original_language = language
        self.cfg = self.cm.get_language_specific_config(language)
        if self.skip_detector is not None:
            sk = self.cfg["skip_detector"]
            self.skip_detector.similarity_threshold = sk["similarity_threshold"]
            self.skip_detector.min_length = sk["min_length"]
            self.skip_detector.containment_threshold = sk["containment_threshold"]
            self.skip_detector.time_window_s = sk["time_window_s"]
            self.skip_detector.reset()
        if self.deduplicator is not None:
            dd = self.cfg["audio_deduplication"]
            self.deduplicator.similarity_threshold = dd["similarity_threshold"]
            self.deduplicator.duplicate_threshold = dd["duplicate_threshold"]
            self.deduplicator.time_window_s = dd["time_window_s"]
            self.deduplicator.reset()
        if self.rate_adaptive is not None:
            ra = self.cfg["speech_rate_adaptive"]
            self.rate_adaptive.detector.slow_cps = ra.get("slow_cps", 5.0)
            self.rate_adaptive.detector.fast_cps = ra.get("fast_cps", 15.0)
            self.rate_adaptive.controller.min_ms = ra["min_silence_ms"]
            self.rate_adaptive.controller.max_ms = ra["max_silence_ms"]
        # per-language vad.* overrides (the reference's hot-swap rebuilds the
        # whole processor, 一键…py:2194-2347; updating in place is equivalent
        # because init() below re-zeroes all streaming state)
        v = self.cfg["vad"]
        vac = getattr(self.processor, "vac", None)
        if vac is not None:
            vac.threshold = v["threshold"]
            vac.set_min_silence_duration_ms(v["min_silence_duration_ms"])
            vac.speech_pad_samples = vac.sampling_rate * v["speech_pad_ms"] / 1000
        # per-language streaming.* overrides
        s = self.cfg["streaming"]
        online = getattr(self.processor, "online", self.processor)
        online.set_agreement_n(s["agreement_n"])
        online.buffer_trimming_sec = s["buffer_trimming_sec"]
        online.prompt_chars = s["prompt_chars"]
        online.prefix_policy = s.get("prefix_policy", online.prefix_policy)
        if hasattr(self.processor, "online_chunk_size"):
            self.processor.online_chunk_size = s["online_chunk_size"]
        self.min_chunk_seconds = s.get("min_chunk_seconds", 1.0)
        self.processor.init()

    def shutdown(self):
        if self.translation is not None:
            self.translation.stop()
        self.output.stop()
        if self.log_manager is not None:
            self.log_manager.close()
