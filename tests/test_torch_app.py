"""The port's StreamingApp against the JAX package's, on the CPU.

- Counterparts of ``tests/test_app.py``'s cases, on the same fake ASRs
  (``tests/test_streaming.py``), the scripted VAD and the simulated mic.
- The JAX app's degraded mode is replaced by the port's device policy:
  ``StreamingApp()`` raises without CUDA, and ``device="cpu"`` builds the
  configured model on the CPU and runs a session there.
- Parity: the JAX ``StreamingApp(asr=TPUWhisperASR)`` and the port's
  ``StreamingApp(asr=TorchWhisperASR(device="cpu"))`` on the golden test-tiny
  weights at f32, the same audio and the same stepping fake clock, in the
  feature sets of bench.py's scenarios 2-5 (``run_scenario``'s overrides;
  4 and 5 at ``int8-all`` with ``prefix_policy`` "last", 5 the trained
  neural separator fused into the encode over music-backed speech) and one
  case with time stretch, adaptive decode parameters and diarization on:
  the emitted lines (speaker labels included), the ``SessionStats``, the
  stretch and diarization stats and the clock's last reading are equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.app import (
    SessionStats,
    StreamingApp,
    validate_timestamps,
)
from realtime_whisper_asr_tpu_torch.config import ConfigManager
from realtime_whisper_asr_tpu_torch.io import SimulatedMicStream
from tests.test_streaming import (
    DispatchingFakeASR,
    ScriptedProbs,
    TimecodedFakeASR,
    make_words,
    timecoded_audio,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000


def _cm(**cfg_over):
    cm = ConfigManager(autoload=False)
    cm.set("audio_deduplication.enable", False)  # timecoded audio is a ramp
    cm.set("performance.display_interval_s", 1e9)
    for k, v in cfg_over.items():
        cm.set(k, v)
    return cm


def _app(words, voice_spans, lines, asr_cls=TimecodedFakeASR, **cfg_over):
    asr = asr_cls(words, unstable_tail=False)
    app = StreamingApp(config=_cm(**cfg_over), asr=asr, language="en",
                       vad_prob_fn=ScriptedProbs(voice_spans), output=lines.append,
                       device="cpu")
    return app, asr


def _text(lines):
    return " ".join(lines)


def test_validate_timestamps():
    assert validate_timestamps(0.0, 1.0, "ok")
    assert not validate_timestamps(2.0, 1.0, "backwards")
    assert not validate_timestamps(None, 1.0, "none")
    assert not validate_timestamps(1.0, 1.0, "x" * 60)
    assert validate_timestamps(1.0, 1.0, "short")


THREE = [(1.2, 1.6, " hello"), (1.7, 2.1, " world"), (4.2, 4.6, " again")]


def test_session_end_to_end():
    lines = []
    app, _ = _app(THREE, [(1.0, 2.5), (4.0, 5.0)], lines)
    stats = app.record_session(SimulatedMicStream(timecoded_audio(0.0, 7.0)), chunk_seconds=0.25)
    app.shutdown()
    text = _text(lines)
    assert "hello" in text and "world" in text and "again" in text
    assert stats.results >= 2
    assert stats.duration_s == pytest.approx(7.0, abs=0.3)


def test_session_auto_pipeline_for_unpaced_feed():
    lines = []
    app, asr = _app(THREE, [(1.0, 2.5), (4.0, 5.0)], lines, DispatchingFakeASR)
    assert app.online.pipeline is False  # constructed sync; the session decides
    stats = app.record_session(SimulatedMicStream(timecoded_audio(0.0, 7.0)), chunk_seconds=0.25)
    app.shutdown()
    assert asr.dispatches > 0
    assert app.online.pipeline is False and app.online._inflight is None
    text = _text(lines)
    assert "hello" in text and "world" in text and "again" in text
    assert stats.results >= 2


def test_session_auto_pipeline_keeps_sync_for_paced_feed():
    lines = []
    app, asr = _app([(0.3, 0.7, " hello")], [(0.2, 1.0)], lines, DispatchingFakeASR)
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 2.0), realtime=True),
                       chunk_seconds=0.5)
    app.shutdown()
    assert asr.dispatches == 0
    assert "hello" in _text(lines)


def test_session_auto_pipeline_beam_selects_exact():
    lines = []
    app, asr = _app(THREE[:2], [(1.0, 2.5)], lines, DispatchingFakeASR)
    asr.beam_size = 5
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 5.0)), chunk_seconds=0.25)
    app.shutdown()
    assert asr.dispatches > 0
    assert app.last_session_pipeline is True  # exact, not "async"
    assert "hello" in _text(lines)


def test_session_explicit_pipeline_config_wins_over_auto():
    lines = []
    app, asr = _app([(0.3, 0.7, " hello")], [(0.2, 1.0)], lines, DispatchingFakeASR,
                    **{"streaming.pipeline": False})
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 2.0)), chunk_seconds=0.5)
    app.shutdown()
    assert asr.dispatches == 0
    assert "hello" in _text(lines)


class _CountingIdentitySeparator:
    name = "identity"

    def __init__(self):
        self.chunks = []
        self.threads = set()

    def separate(self, audio):
        import threading

        self.chunks.append(np.asarray(audio))
        self.threads.add((threading.current_thread().name, torch.is_inference_mode_enabled()))
        return audio

    def get_stats(self):
        return {"processed": len(self.chunks)}


def test_session_pipelined_separation_preserves_stream():
    """The read-ahead worker separates each chunk exactly once, in order,
    on its own thread under its own inference mode."""
    lines = []
    app, _ = _app(THREE, [(1.0, 2.5), (4.0, 5.0)], lines)
    sep = _CountingIdentitySeparator()
    app.separator = sep
    audio = timecoded_audio(0.0, 7.0)
    stats = app.record_session(SimulatedMicStream(audio), chunk_seconds=0.25)
    app.shutdown()
    text = _text(lines)
    assert "hello" in text and "world" in text and "again" in text
    assert stats.results >= 2
    np.testing.assert_array_equal(np.concatenate(sep.chunks), audio)
    assert sep.threads == {("read-sep", True)}


def test_session_skip_detector_suppresses_duplicates():
    lines = []
    app, _ = _app([(1.2, 1.6, " same"), (4.2, 4.6, " same")], [(1.0, 2.0), (4.0, 5.0)], lines)
    stats = app.record_session(SimulatedMicStream(timecoded_audio(0.0, 7.0)), chunk_seconds=0.25)
    app.shutdown()
    assert sum("same" in line for line in lines) == 1
    assert stats.skipped >= 1


@pytest.mark.parametrize("separated", [False, True], ids=["serial", "read-ahead"])
def test_session_device_recovery(separated):
    lines = []
    app, _ = _app(make_words(6), [(0.0, 30.0)], lines)
    if separated:
        app.separator = _CountingIdentitySeparator()
    stream = SimulatedMicStream(timecoded_audio(0.0, 8.0), fail_at_reads={10})
    stats = app.record_session(stream, chunk_seconds=0.25)
    app.shutdown()
    assert stats.recoveries == 1
    assert stats.results > 0


def test_translation_sink_receives_results():
    lines = []
    app, _ = _app([(1.2, 1.6, " hola"), (1.7, 2.1, " mundo")], [(1.0, 2.5)], lines,
                  **{"translation.enable": True, "translation.interval_s": 1e9})
    app.translation.transport = lambda text, lang: "\n".join(
        "ZH:" + line for line in text.splitlines())
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 5.0)), chunk_seconds=0.25)
    app.translation.process_once()
    app.output.flush()
    app.shutdown()
    assert any(line.startswith("🌐 ZH:") for line in lines)


def test_language_hot_swap_resets_state():
    lines = []
    app, _ = _app(make_words(5), [(0.0, 30.0)], lines)
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 4.0)), chunk_seconds=0.25)
    app.change_language("zh")
    assert app.language == "zh"
    assert app.skip_detector.similarity_threshold == 0.90
    assert app.skip_detector.get_stats()["total"] == 0
    assert app.processor.vac.threshold == 0.6
    assert app.processor.vac.min_silence_samples == 16000 * 400 / 1000
    assert app.processor.online.agreement_n == 3
    app.change_language("en")
    assert app.processor.vac.threshold == 0.5
    assert app.processor.online.agreement_n == 2
    app.shutdown()


def test_separator_factory_per_method_kwargs():
    from realtime_whisper_asr_tpu_torch.pipeline import create_separator

    common = {"low_hz": 85.0, "high_hz": 3400.0, "device": "cpu"}
    assert create_separator("filter", **common).name == "filter"
    assert create_separator("neural", **common).name == "neural"
    assert create_separator("demucs", **common, model_name="htdemucs").name == "filter"
    assert create_separator("none", **common) is None


def test_app_separation_fuses_into_the_asr_or_runs_on_the_host():
    """A trained neural separator fuses into an ASR that has the frontend
    (none is left for the host loop); with ``fuse_encode`` off, or an ASR
    without the frontend, it separates on the host."""

    class FrontendASR(TimecodedFakeASR):
        def set_separation_frontend(self, params):
            self.frontend = params

    over = {"vocal_separation.enable": True, "vocal_separation.method": "neural"}
    app, asr = _app(make_words(2), [(0.0, 30.0)], [], FrontendASR, **over)
    assert app.fused_separation and app.separator is None
    from realtime_whisper_asr_tpu_torch.models.separation_nn import VARIANT_WEIGHTS

    packaged = np.load(VARIANT_WEIGHTS["default"])
    assert sorted(asr.frontend) == sorted(packaged.files)
    assert all(np.array_equal(asr.frontend[k], packaged[k]) for k in packaged.files)
    app.shutdown()
    app, _ = _app(make_words(2), [(0.0, 30.0)], [], FrontendASR,
                  **over, **{"vocal_separation.fuse_encode": False})
    assert not app.fused_separation and app.separator.name == "neural"
    assert app.separator.device == torch.device("cpu")
    app.shutdown()
    app, _ = _app(make_words(2), [(0.0, 30.0)], [], **over)
    assert app.separator is not None and app.separator.name == "neural"
    app.shutdown()


def test_session_without_vad_direct_online():
    from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

    lines = []
    asr = TimecodedFakeASR(make_words(6), unstable_tail=False)
    app = StreamingApp(config=_cm(**{"vad.enable": False}), asr=asr, language="en",
                       output=lines.append, device="cpu")
    assert isinstance(app.processor, OnlineASRProcessor)
    stats = app.record_session(SimulatedMicStream(timecoded_audio(0.0, 5.0)), chunk_seconds=1.0)
    app.shutdown()
    assert stats.results > 0
    assert any("word0" in line for line in lines)


class _DetectingFakeASR(TimecodedFakeASR):
    def __init__(self, words, answers):
        super().__init__(words, unstable_tail=False)
        self.answers = iter(answers)
        self.detect_calls = []

    def detect_language(self, audio):
        self.detect_calls.append(len(audio) / SR)
        return next(self.answers)


def _auto_language_app(asr, lines):
    return StreamingApp(config=_cm(**{"language_detection.enable": True,
                                      "language_detection.consecutive": 2,
                                      "language_detection.min_audio_s": 0.5}),
                        asr=asr, language="en",
                        vad_prob_fn=ScriptedProbs([(1.0, 2.0), (4.0, 5.0), (7.0, 8.0)]),
                        output=lines.append, device="cpu")


def test_auto_language_switches_after_consecutive_detections():
    words = [(1.2, 1.6, " one"), (4.2, 4.6, " two"), (7.2, 7.6, " three")]
    asr = _DetectingFakeASR(words, [("zh", 0.93)] * 5)
    lines = []
    app = _auto_language_app(asr, lines)
    assert app.auto_language is not None
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 10.0)), chunk_seconds=0.25)
    app.shutdown()
    assert len(asr.detect_calls) >= 2
    assert app.language == "zh"
    assert getattr(app.processor, "online", app.processor).agreement_n == 3
    assert app.auto_language.get_stats()["detections"] >= 2
    assert app.auto_language.get_stats()["switches"] == 1
    assert any("three" in line for line in lines)


def test_auto_language_ignores_low_confidence_and_same_language():
    words = [(1.2, 1.6, " a"), (4.2, 4.6, " b"), (7.2, 7.6, " c")]
    asr = _DetectingFakeASR(words, [("zh", 0.2), ("en", 0.9), ("zh", 0.9)])
    app = _auto_language_app(asr, [])
    app.record_session(SimulatedMicStream(timecoded_audio(0.0, 10.0)), chunk_seconds=0.25)
    app.shutdown()
    assert app.language == "en"


def test_asr_optimization_knobs_are_wired():
    asr = TimecodedFakeASR([(0.6, 1.0, " steady"), (1.4, 1.8, " words")], unstable_tail=False)
    app = StreamingApp(config=_cm(**{"asr_optimization.time_stretch_enable": True,
                                     "asr_optimization.adaptive_params_enable": True}),
                       asr=asr, language="en", vad_prob_fn=ScriptedProbs([(0.2, 2.2)]),
                       device="cpu")
    assert app.stretch_processor is not None and app.stretch_processor.device.type == "cpu"
    assert app._rate_detector is not None
    assert getattr(app.asr, "adaptive_params", None) is not None
    stats = app.record_session(SimulatedMicStream(timecoded_audio(0.0, 4.0)), chunk_seconds=0.5)
    app.shutdown()
    assert stats.results >= 1
    assert app.asr.adaptive_params.rate_class in ("slow", "normal", "fast", "unknown")


# ------------------------------------------------------------- device policy


def test_app_refuses_missing_cuda(monkeypatch):
    """The JAX app's degraded mode is not ported: without CUDA the default
    device raises, whatever the model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingApp(config=_cm(**{"model.size": "large-v3"}), language="en")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingApp(config=_cm(), asr=TimecodedFakeASR([]), language="en")


def test_app_builds_the_configured_model_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cm = _cm(**{"model.size": "test-tiny", "model.dtype": "float32",
                "model.max_tokens_per_second": 4.0})
    lines = []
    app = StreamingApp(config=cm, language="en", vad_prob_fn=ScriptedProbs([(0.0, 30.0)]),
                       output=lines.append, device="cpu")
    assert app.asr.device == torch.device("cpu") and app.asr.cfg.name == "test-tiny"
    assert app.asr.model.dtype == torch.float32 and app.asr.max_tokens_per_second == 4.0
    stats = app.record_session(SimulatedMicStream(timecoded_audio(0.0, 3.0) * 300.0),
                               chunk_seconds=1.0)
    app.shutdown()
    assert stats.chunks == 3 and stats.duration_s == pytest.approx(3.0)


# ------------------------------------------------------------------- parity


def synthetic_speech(seconds: float, seed: int = 0) -> np.ndarray:
    """bench.py's synthetic feed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.61 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    env = 0.55 * (1 + np.sin(2 * np.pi * 2.7 * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


def music_backed_speech(seconds: float, seed: int = 0) -> np.ndarray:
    """bench.py's speech over background music (scenario 5)."""
    speech = synthetic_speech(seconds, seed)
    t = np.arange(int(seconds * SR)) / SR
    music = 0.15 * (np.sin(2 * np.pi * 220 * t) + 0.7 * np.sin(2 * np.pi * 330 * t)
                    + 0.5 * np.sin(2 * np.pi * 55 * t))
    return (speech + music.astype(np.float32)).astype(np.float32)


_OFF = {"audio_deduplication.enable": False, "skip_detector.enable": False,
        "speech_rate_adaptive.enable": False}
#: bench.py's run_scenario setups 2-5 (their models cut to test-tiny), and
#: the speech-rate features with diarization
PARITY = {
    "scenario2": dict(language="en", overrides=dict(_OFF)),
    "scenario3": dict(language="zh", overrides={"skip_detector.enable": True,
                                                "streaming.agreement_n": 2,
                                                "audio_deduplication.enable": False}),
    "scenario4": dict(language="en", task="translate", quantization="int8-all",
                      overrides=dict(_OFF, **{"audio_deduplication.enable": True,
                                              "streaming.prefix_policy": "last"})),
    "scenario5": dict(language="en", quantization="int8-all", music=True,
                      overrides=dict(_OFF, **{"vocal_separation.enable": True,
                                              "vocal_separation.method": "neural",
                                              "vocal_separation.fuse_encode": True,
                                              "streaming.prefix_policy": "last"})),
    "rate-diarize": dict(language="en", seconds=12.0,
                         overrides={"audio_deduplication.enable": False,
                                    "asr_optimization.time_stretch_enable": True,
                                    "asr_optimization.adaptive_params_enable": True,
                                    "diarization.enable": True,
                                    "diarization.min_audio_s": 0.3}),
}


def _session(pkg: str, case: dict) -> dict:
    if pkg == "jax":
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import golden as G

        from realtime_whisper_asr_tpu.app import StreamingApp as App
        from realtime_whisper_asr_tpu.config import ConfigManager as CM
        from realtime_whisper_asr_tpu.io import SimulatedMicStream as Mic

        asr = G.build_asr(quantization=case.get("quantization"))
        kw = {}
    else:
        from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
        from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
        from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

        App, CM, Mic = StreamingApp, ConfigManager, SimulatedMicStream
        asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                              params=load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                              quantization=case.get("quantization"))
        asr.transcribe_kargs["max_total_tokens"] = 24  # as build_asr
        kw = {"device": "cpu"}
    if case.get("task") == "translate":
        asr.set_translate_task()
    asr.original_language = case["language"]
    cm = CM(autoload=False)
    cm.set("performance.display_interval_s", 1e9)
    for k, v in case["overrides"].items():
        cm.set(k, v)
    now = {"t": 0.0}

    def clock():
        now["t"] += 0.01
        return now["t"]

    lines = []
    app = App(config=cm, asr=asr, language=case["language"], task=case.get("task", "transcribe"),
              output=lines.append, clock=clock, **kw)
    seconds = case.get("seconds", 8.0)
    audio = music_backed_speech(seconds) if case.get("music") else synthetic_speech(seconds)
    stats = app.record_session(Mic(audio), chunk_seconds=1.0)
    app.output.flush()
    out = {"lines": lines, "stats": dict(stats.__dict__), "clock": now["t"],
           "fused": app.fused_separation, "pipeline": app.last_session_pipeline,
           "stretch": dict(app.stretch_processor.stats) if app.stretch_processor else None,
           "rate_class": getattr(asr.adaptive_params, "rate_class", None)
           if getattr(asr, "adaptive_params", None) is not None else None,
           "diarizer": app.diarizer.get_stats() if app.diarizer else None}
    app.shutdown()
    return out


@pytest.mark.parametrize("name", list(PARITY))
def test_app_session_equals_jax(name):
    case = PARITY[name]
    got, want = _session("torch", case), _session("jax", case)
    assert got == want
    assert got["lines"] and got["stats"]["results"] >= 1 and got["pipeline"] == "async"
    assert got["fused"] == (name == "scenario5")
    if name == "rate-diarize":
        assert got["stretch"]["stretched"] >= 4 and got["rate_class"] == "fast"
        assert got["diarizer"]["utterances"] >= 2 and got["diarizer"]["speakers"] >= 2
        assert any("[S1]" in line for line in got["lines"])
