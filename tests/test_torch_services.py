"""Counterparts of ``tests/test_services.py``'s cases for the port's copied
services (translation batching and retry, async output overflow, the
performance display, CSV logging), the config manager (defaults, merge and
validation, language precedence, the 18 language blocks, save) and ``io``
(WAV round trip and resampling, the simulated mic, the device protector),
plus: the port's default config equals the JAX package's; the translation
transport imports ``requests`` only when called (the tests inject one, and
nothing touches the network); ``MicrophoneStream`` raises without
``sounddevice``, as the JAX one does."""

import os
import time

import numpy as np
import pytest

from realtime_whisper_asr_tpu_torch.config import ConfigManager, DEFAULT_CONFIG
from realtime_whisper_asr_tpu_torch.io import (
    AudioDeviceProtector,
    SimulatedMicStream,
    read_wav,
    write_wav,
)
from realtime_whisper_asr_tpu_torch.services import (
    AsyncOutput,
    LogManager,
    PerformanceDisplay,
    PerformanceMonitor,
    TranslationManager,
)


# ------------------------------------------------------------- translation


def test_translation_batches_and_callbacks():
    sent = []
    calls = []

    def transport(text, lang):
        calls.append(text)
        return "\n".join("T:" + l for l in text.splitlines())

    tm = TranslationManager(output_callback=lambda s, t: sent.append((s, t)),
                            transport=transport)
    assert tm.add_text("hello")
    assert tm.add_text("world")
    assert not tm.add_text("hello")  # dedup on entry
    tm.process_once()
    assert calls == ["hello\nworld"]  # merged into ONE request
    assert sent == [("hello", "T:hello"), ("world", "T:world")]
    st = tm.get_stats()
    assert st["translated"] == 2 and st["deduped"] == 1 and st["requests"] == 1


def test_translation_retry_once_then_drop():
    attempts = []

    def failing(text, lang):
        attempts.append(text)
        raise RuntimeError("api down")

    tm = TranslationManager(transport=failing)
    tm.add_text("abc")
    tm.process_once()  # fail #1 -> retry_count 1, requeued
    assert tm.get_stats()["pending"] == 1
    tm.add_text("def")
    tm.process_once()  # fail #2: abc dropped, def requeued
    tm.process_once()  # fail #3: def dropped
    st = tm.get_stats()
    assert st["pending"] == 0
    assert st["dropped"] == 2
    assert len(attempts) == 3


def test_translation_worker_thread_lifecycle():
    tm = TranslationManager(transport=lambda t, l: t, translate_interval=0.05)
    tm.add_text("x")
    tm.start()
    time.sleep(0.2)
    tm.stop()
    assert tm.get_stats()["translated"] == 1


# ------------------------------------------------------------ async output


def test_async_output_order_and_overflow():
    lines = []
    out = AsyncOutput(maxsize=2, write=lines.append)
    for i in range(10):
        out.print(f"line{i}")
    out.stop()
    assert set(f"line{i}" for i in range(10)) <= set(lines)
    assert out.dropped_to_sync > 0  # overflow path exercised


# ------------------------------------------------------------ perf monitor


def test_perf_monitor_ratio_and_backpressure():
    pm = PerformanceMonitor()
    assert pm.should_skip_recognition(1.0) == (False, "ok")
    for _ in range(5):
        pm.record_recognition(audio_seconds=1.0, processing_seconds=0.1)
    assert pm.get_recognition_speed_ratio() == pytest.approx(10.0)
    assert pm.rtf() == pytest.approx(0.1)
    # degrade: slower than 0.4x realtime
    for _ in range(20):
        pm.record_recognition(audio_seconds=1.0, processing_seconds=3.0)
    skip, why = pm.should_skip_recognition(1.0)
    assert skip
    pm.set_queue_depth(5)
    assert pm.should_skip_recognition(1.0)[0]
    st = pm.get_status()
    assert st["p50_ms"] > 0 and st["skips"] >= 2


def test_perf_display_throttles():
    lines = []
    now = [0.0]
    d = PerformanceDisplay(interval_s=5.0, color=False, write=lines.append,
                           clock=lambda: now[0])
    d.display_stats(force=True)
    d.display_stats()  # throttled
    now[0] = 6.0
    d.display_stats()
    assert len(lines) == 2
    d.display_error("boom")
    assert any("boom" in l for l in lines)
    assert PerformanceDisplay.format_duration(3723) == "01:02:03"


# -------------------------------------------------------------- log manager


def test_log_manager_csv(tmp_path):
    lm = LogManager(log_dir=str(tmp_path), session_name="t1")
    lm.log_recognition(0.0, 1.5, "hello", latency_ms=42.0, language="en", model="tiny")
    lm.log_skip("dup text", "exact_duplicate")
    lm.log_translation("hello", "你好")
    lm.log_performance(rtf=0.05, latency_ms=40.0)
    lm.log_error("oops")
    lm.close()
    csv_text = open(os.path.join(tmp_path, "session_t1.csv")).read()
    assert csv_text.count("\n") == 6  # header + 5 rows
    assert "exact_duplicate" in csv_text and "你好" in csv_text
    assert os.path.exists(os.path.join(tmp_path, "session_t1.log"))


# ------------------------------------------------------------------- config


def test_config_defaults_and_dotted_access(tmp_path):
    cm = ConfigManager(str(tmp_path / "none.json"))
    assert cm.get("streaming.agreement_n") == 2
    cm.set("streaming.agreement_n", 3)
    assert cm.get("streaming.agreement_n") == 3
    assert cm.get("nope.nothing", "dflt") == "dflt"


def test_config_file_merge_and_validation(tmp_path):
    p = tmp_path / "config.json"
    p.write_text('{"vad": {"threshold": 5.0}, "streaming": {"agreement_n": 4}, '
                 '"_comment_x": "ignored"}')
    cm = ConfigManager(str(p))
    assert cm.get("streaming.agreement_n") == 4  # user override survives
    assert cm.get("vad.threshold") == 0.95  # out-of-range clamped
    assert cm.get("skip_detector.enable") is True  # default filled in


def test_config_language_precedence(tmp_path):
    cm = ConfigManager(str(tmp_path / "none.json"))
    zh = cm.get_language_specific_config("zh")
    assert zh["skip_detector"]["similarity_threshold"] == 0.90  # lang override
    assert zh["skip_detector"]["time_window_s"] == 10.0  # base preserved
    en = cm.get_language_specific_config("xx")  # unknown language = base
    assert en["skip_detector"]["similarity_threshold"] == 0.85


def test_config_all_18_language_blocks_populated_and_clamp_clean(tmp_path):
    """VERDICT r3 #7: every reference language (config.json:110-727) gets a
    real tuning block — non-empty, covering the tuned dimensions, and every
    value already inside the _VALIDATION ranges (merging a language must
    never trip a clamp warning)."""
    from realtime_whisper_asr_tpu_torch.config.manager import _VALIDATION

    langs = ["zh", "en", "ja", "ko", "es", "fr", "de", "ru", "it", "pt",
             "ar", "hi", "th", "vi", "id", "nl", "pl", "tr"]
    cm = ConfigManager(str(tmp_path / "none.json"))
    assert sorted(cm.get("language_specific").keys()) == sorted(langs)
    for lang in langs:
        block = cm.get(f"language_specific.{lang}")
        assert block, f"{lang} block is empty"
        for section in ("skip_detector", "streaming", "speech_rate_adaptive", "vad"):
            assert section in block, (lang, section)
        merged = cm.get_language_specific_config(lang)
        # merged values sit inside every validation range (no clamping needed)
        for path, (lo, hi) in _VALIDATION.items():
            node = merged
            for part in path.split("."):
                node = node.get(part) if isinstance(node, dict) else None
                if node is None:
                    break
            if isinstance(node, (int, float)):
                assert lo <= node <= hi, (lang, path, node)
        sra = merged["speech_rate_adaptive"]
        assert sra["min_silence_ms"] <= sra["initial_silence_ms"] <= sra["max_silence_ms"], lang
        assert sra["slow_cps"] < sra["fast_cps"], lang


def test_config_save_roundtrip(tmp_path):
    p = tmp_path / "c.json"
    cm = ConfigManager(str(p))
    cm.set("model.size", "small")
    assert cm.save_config()
    cm2 = ConfigManager(str(p))
    assert cm2.get("model.size") == "small"


# ----------------------------------------------------------------------- io


def test_wav_roundtrip(tmp_path):
    path = str(tmp_path / "t.wav")
    audio = (0.5 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)).astype(np.float32)
    write_wav(path, audio)
    back = read_wav(path)
    assert back.shape == audio.shape
    np.testing.assert_allclose(back, audio, atol=1e-3)


def test_wav_resample(tmp_path):
    path = str(tmp_path / "t8.wav")
    audio = np.zeros(8000, np.float32)
    write_wav(path, audio, sr=8000)
    back = read_wav(path, target_sr=16000)
    assert abs(len(back) - 16000) <= 2


def test_simulated_mic_pads_and_fails_on_schedule():
    mic = SimulatedMicStream(np.ones(1000, np.float32), fail_at_reads={3})
    a, _ = mic.read(600)
    assert a.sum() == 600
    a, _ = mic.read(600)  # 400 real + 200 pad
    assert a.sum() == 400
    with pytest.raises(OSError):
        mic.read(600)


def test_protector_retry_and_recovery():
    calls = {"made": 0}

    class FlakyFactory:
        def __call__(self):
            calls["made"] += 1
            if calls["made"] == 1:
                raise OSError("device busy")
            return SimulatedMicStream(np.ones(100000, np.float32),
                                      fail_at_reads={5})

    prot = AudioDeviceProtector(FlakyFactory(), retry_delay_s=0.0, recover_delay_s=0.0)
    prot.open_stream()  # first factory call fails, second succeeds
    assert calls["made"] == 2
    for _ in range(3):
        data, recovered = prot.read_audio(256)
        assert not recovered
    data, recovered = prot.read_audio(256)  # read #5 on this stream fails
    assert recovered and len(data) == 256
    st = prot.get_status()
    assert st["recoveries"] == 1 and st["healthy"]
    prot.close()
    assert prot.get_status()["open"] is False


def test_protector_gives_up_after_max_retries():
    def always_fail():
        raise OSError("no device")

    prot = AudioDeviceProtector(always_fail, max_retries=3, retry_delay_s=0.0)
    assert prot.check_device_available() is False
    with pytest.raises(RuntimeError):
        prot.open_stream()



def test_translation_misaligned_batch_recovers_per_line():
    """A merged request that comes back with the WRONG number of lines must
    not positionally pair (wrong translation for every line after the shift)
    nor silently drop the tail — the batch re-queues and drains as one-text
    requests, which cannot misalign."""
    calls = []
    out = []

    def transport(text, lang):
        calls.append(text)
        srcs = text.split("\n")
        if len(srcs) > 1:  # merged request: model fuses two sentences
            return "merged-line-1"
        return f"t({srcs[0]})"

    tm = TranslationManager(output_callback=lambda s, t: out.append((s, t)),
                            transport=transport)
    for s in ("aaa", "bbb", "ccc"):
        tm.add_text(s)
    tm.process_once()  # merged request, 1 line for 3 texts -> re-queue all
    assert out == []
    assert tm.stats.get("misaligned") == 1
    tm.process_once()
    tm.process_once()
    tm.process_once()
    assert out == [("aaa", "t(aaa)"), ("bbb", "t(bbb)"), ("ccc", "t(ccc)")]
    assert tm.stats["translated"] == 3
    assert tm.stats["dropped"] == 0


def test_translation_misalignment_retries_survive_fresh_arrivals():
    """Fresh texts queued between the misaligned batch and its per-line
    retries must not consume the single-item budget: the re-queued items go
    to the FRONT and drain one request each, so they can never be merged
    into a second misalignable request (round-3 review finding)."""
    out = []

    def transport(text, lang):
        srcs = text.split("\n")
        if len(srcs) > 1:
            return "merged"  # every multi-text request misaligns
        return f"t({srcs[0]})"

    tm = TranslationManager(output_callback=lambda s, t: out.append((s, t)),
                            transport=transport)
    for s in ("aaa", "bbb", "ccc"):
        tm.add_text(s)
    tm.process_once()  # misaligns; aaa/bbb/ccc re-queued at the FRONT
    tm.add_text("ddd")  # fresh arrival mid-recovery
    tm.add_text("eee")
    for _ in range(4):
        tm.process_once()
    # retries drained first, one per interval; nothing dropped
    assert ("aaa", "t(aaa)") in out and ("ccc", "t(ccc)") in out
    assert tm.stats["dropped"] == 0
    # the fresh pair then went out as one merged request, which misaligned
    # and re-queued THEM at the front for their own single-item recovery
    tm.process_once()
    tm.process_once()
    assert ("ddd", "t(ddd)") in out and ("eee", "t(eee)") in out
    assert tm.stats["dropped"] == 0


def test_translation_solo_drop_does_not_throttle_fresh_texts():
    """A misalignment-retry item that then FAILS its own single request is
    dropped at the retry cap — that drop must not leave a stale single-item
    throttle behind for fresh texts (the old counter did; round-3 review)."""
    out = []
    calls = []

    def transport(text, lang):
        calls.append(text)
        srcs = text.split("\n")
        if len(srcs) > 1 and any(s.startswith("bad") for s in srcs):
            return "merged"  # misalign any batch containing 'bad'
        if srcs[0].startswith("bad"):
            raise RuntimeError("boom")  # its solo retry then fails -> dropped
        return "\n".join(f"t({s})" for s in srcs)

    tm = TranslationManager(output_callback=lambda s, t: out.append((s, t)),
                            transport=transport)
    tm.add_text("bad1")
    tm.add_text("bad2")
    tm.process_once()   # merged 'bad1\nbad2' misaligns -> both solo-requeued
    tm.process_once()   # bad1 solo fails -> retry cap -> dropped
    tm.process_once()   # bad2 solo fails -> dropped
    assert tm.stats["dropped"] == 2
    tm.add_text("aaa")
    tm.add_text("bbb")
    tm.process_once()   # fresh texts must go out MERGED, not one-per-interval
    assert ("aaa", "t(aaa)") in out and ("bbb", "t(bbb)") in out
    assert calls[-1] == "aaa\nbbb"


# ------------------------------------------------------------ port-specific


def test_default_config_equals_the_jax_packages():
    from realtime_whisper_asr_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT

    assert DEFAULT_CONFIG == JAX_DEFAULT
    assert ConfigManager(autoload=False).config == JAX_DEFAULT


def test_translation_transport_imports_requests_lazily(monkeypatch):
    import sys

    from realtime_whisper_asr_tpu_torch.services import translation

    monkeypatch.setitem(sys.modules, "requests", None)  # unimportable
    tm = TranslationManager(transport=lambda t, lang: t)
    tm.add_text("x")
    tm.process_once()
    assert tm.get_stats()["translated"] == 1
    monkeypatch.setenv(translation.MODEL_CONFIG["api_key_env"], "k")
    with pytest.raises(ImportError):
        translation.default_transport("x")


def test_microphone_stream_needs_sounddevice(monkeypatch):
    import sys

    from realtime_whisper_asr_tpu_torch.io import MicrophoneStream, list_audio_devices

    monkeypatch.setitem(sys.modules, "sounddevice", None)
    assert list_audio_devices() == []
    with pytest.raises(RuntimeError):
        MicrophoneStream()
