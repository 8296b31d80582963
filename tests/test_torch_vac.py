"""VAC streaming through the port, on the CPU.

- The VAC cases of tests/test_streaming.py (its ``TimecodedFakeASR`` and
  ``ScriptedProbs``) run over both packages' classes: the port's
  ``VADIterator``, ``VACOnlineASRProcessor`` and ``OnlineASRProcessor`` and
  the JAX package's pass the same checks.
- The golden ``vac`` row (tools/golden.py:177-203) reproduces through the
  port: test-tiny with the committed weights at f32, the packaged
  Silero-like VAD, text and commit count.
- ``pipeline=True`` commits the synchronous stream's words; ``"async"``
  commits the JAX package's async words on the golden VAC audio (under
  both prefix policies); an utterance start drops the in-flight tick, and
  its device draft never reaches the next utterance's ticks.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import realtime_whisper_asr_tpu.streaming as JS
import realtime_whisper_asr_tpu_torch.streaming as PS
from realtime_whisper_asr_tpu.models.vad import SileroLikeVAD as JaxSileroLikeVAD
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD
from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000
PACKAGES = {"jax": JS, "torch": PS}


def golden_vac_audio() -> np.ndarray:
    """tools/golden.py's VAC clip (tests/test_torch_vad.py holds it equal to
    the recorder's)."""
    rng = np.random.default_rng(2024)
    a, _ = synth_speech(rng, 3.0)
    b, _ = synth_speech(rng, 3.0)
    gap = np.zeros(int(1.2 * SR), np.float32)
    lead = np.zeros(int(0.4 * SR), np.float32)
    return np.concatenate([lead, a, gap, b, gap]).astype(np.float32)


# ------------------------------------------- tests/test_streaming.py's fakes


def timecoded_audio(t0: float, t1: float) -> np.ndarray:
    k = np.arange(int(t0 * SR), int(t1 * SR))
    return (k / SR * 1e-3).astype(np.float32)


class TimecodedFakeASR:
    """Serves the ground-truth words inside the buffer's window, read back
    from the audio's values (sample k holds k/SR * 1e-3)."""

    sep = ""

    def __init__(self, words):
        self.words = words

    def transcribe(self, audio, init_prompt=""):
        if len(audio) == 0:
            return []
        t0 = float(audio[0]) * 1e3
        t1 = t0 + len(audio) / SR
        return [(b - t0, e - t0, w) for b, e, w in self.words
                if b >= t0 - 1e-6 and e <= t1 + 1e-6]

    def ts_words(self, segments):
        return segments

    def segments_end_ts(self, segments):
        return [e for _, e, _ in segments]


class ScriptedProbs:
    """prob_fn driven by a [(start_s, end_s)] voice script."""

    def __init__(self, spans):
        self.spans = spans
        self.pos = 0

    def __call__(self, frames):
        out = []
        for _ in frames:
            t = self.pos * 512 / SR
            out.append(1.0 if any(a <= t < b for a, b in self.spans) else 0.0)
            self.pos += 1
        return np.array(out, np.float32)


def _vac(S, words, spans, min_silence_ms=500, chunk_s=0.5):
    return S.VACOnlineASRProcessor(
        S.OnlineASRProcessor(TimecodedFakeASR(words)),
        S.VADIterator(ScriptedProbs(spans), min_silence_duration_ms=min_silence_ms,
                      speech_pad_ms=0),
        online_chunk_size=chunk_s)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_vad_iterator_events_and_min_silence(pkg):
    vad = PACKAGES[pkg].VADIterator(ScriptedProbs([(1.0, 3.0)]), min_silence_duration_ms=500,
                                    speech_pad_ms=0)
    events = []
    t = 0.0
    while t < 5.0:
        for ev in vad(np.zeros(int(0.1 * SR), np.float32)):
            events.append((round(t, 1), ev))
        t += 0.1
    (_, ev_s), (t_end, ev_e) = events
    assert abs(ev_s["start"] / SR - 1.0) < 0.1 and abs(ev_e["end"] / SR - 3.0) < 0.1
    assert 3.4 <= t_end <= 3.7  # delayed by min_silence


@pytest.mark.parametrize("pkg", PACKAGES)
def test_vad_dynamic_min_silence(pkg):
    vad = PACKAGES[pkg].VADIterator(ScriptedProbs([(0.5, 1.0), (1.3, 1.8)]),
                                    min_silence_duration_ms=500, speech_pad_ms=0)
    vad.set_min_silence_duration_ms(100)
    events = []
    for _ in range(30):
        events.extend(vad(np.zeros(int(0.1 * SR), np.float32)))
    assert [next(iter(e)) for e in events] == ["start", "end", "start", "end"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_vac_processor_routes_and_finalizes(pkg):
    vac = _vac(PACKAGES[pkg], [(1.2, 1.6, " hello"), (1.7, 2.1, " world")], [(1.0, 2.5)],
               min_silence_ms=300)
    outs = []
    t = 0.0
    while t < 4.0:
        vac.insert_audio_chunk(timecoded_audio(t, t + 0.1))
        t += 0.1
        outs.append(vac.process_iter())
    texts = "".join(txt for _, _, txt in outs if txt)
    assert "hello" in texts and "world" in texts
    assert vac.set_silence_duration(250) is True
    assert vac.vac.min_silence_samples == 250 * SR / 1000


@pytest.mark.parametrize("pkg", PACKAGES)
def test_vac_end_then_start_in_one_chunk_preserves_both_utterances(pkg):
    vac = _vac(PACKAGES[pkg], [(0.5, 0.9, " first"), (2.6, 3.0, " second")],
               [(0.3, 1.2), (2.4, 3.4)], min_silence_ms=200, chunk_s=0.4)
    outs = []
    t = 0.0
    while t < 4.2:
        vac.insert_audio_chunk(timecoded_audio(t, t + 1.4))
        t += 1.4
        outs.append(vac.process_iter())
    outs.append(vac.finish())
    text = "".join(txt for _, _, txt in outs if txt)
    assert "first" in text and "second" in text, outs


WORDS3 = [(0.4, 0.8, " one"), (2.4, 2.8, " two"), (4.4, 4.8, " three")]
SPANS3 = [(0.2, 1.0), (2.2, 3.0), (4.2, 5.0)]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_vac_multiple_staged_utterances_all_transcribed(pkg):
    vac = _vac(PACKAGES[pkg], WORDS3, SPANS3)
    vac.insert_audio_chunk(timecoded_audio(0.0, 1.0))
    vac.insert_audio_chunk(timecoded_audio(1.0, 2.0))  # u1's end
    assert vac.is_currently_final and not vac.wants_tick()
    vac.insert_audio_chunk(timecoded_audio(2.0, 6.0))  # u2 and u3 staged
    assert len(vac._pending) == 2 and vac._pending[0][2] is True
    texts = [t for _, _, t in (vac.process_iter() for _ in range(6)) if t]
    texts.append(vac.finish()[2])
    joined = "".join(texts)
    assert "one" in joined and "two" in joined and "three" in joined, joined


@pytest.mark.parametrize("pkg", PACKAGES)
def test_vac_finish_all_drains_staged_utterances(pkg):
    vac = _vac(PACKAGES[pkg], WORDS3, SPANS3)
    for t0, t1 in ((0.0, 1.0), (1.0, 2.0), (2.0, 6.0)):
        vac.insert_audio_chunk(timecoded_audio(t0, t1))
    assert len(vac._pending) == 2
    joined = "".join(t for _, _, t in vac.finish_all())
    assert "one" in joined and "two" in joined and "three" in joined, joined
    assert not vac._pending


@pytest.mark.parametrize("pkg", PACKAGES)
def test_online_finish_all_single_flush(pkg):
    online = PACKAGES[pkg].OnlineASRProcessor(TimecodedFakeASR([(0.2, 0.6, " hello")]))
    assert not online.wants_tick()
    online.insert_audio_chunk(timecoded_audio(0.0, 1.0))
    assert online.wants_tick()
    online.process_iter()
    out = online.finish_all()
    assert len(out) == 1 and "hello" in out[0][2]
    assert online.finish_all() == []


# ------------------------------------------------- the golden VAC row, port


def _golden_state() -> dict:
    return load_flat_npz(os.path.join(GOLDEN, "params.npz"))


@pytest.fixture(scope="module")
def asr():
    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=_golden_state())
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    return asr


def run_vac(S, asr, vad, pipeline=False, prefix_policy="agree2"):
    """tools/golden.py's VAC drive: 0.5 s chunks, trimming at 15 s ->
    (returned texts, every committed word across utterances)."""
    online = S.OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0), pipeline=pipeline,
                                  prefix_policy=prefix_policy)
    words = []
    init = online.init

    def keeping_init(offset=None):  # an utterance start wipes ``commited``
        words.extend(getattr(online, "commited", []))
        init(offset)

    online.init = keeping_init
    vac = S.VACOnlineASRProcessor(
        online, S.VADIterator(vad, threshold=0.5, min_silence_duration_ms=500,
                              speech_pad_ms=100),
        online_chunk_size=0.5)
    audio = golden_vac_audio()
    pieces = []
    for pos in range(0, len(audio), SR // 2):
        vac.insert_audio_chunk(audio[pos : pos + SR // 2])
        pieces.append(vac.process_iter()[2])
    pieces.append(vac.finish()[2])
    words.extend(online.commited)
    return [p for p in pieces if p], [(round(b, 3), round(e, 3), w) for b, e, w in words]


@pytest.fixture(scope="module")
def port_runs(asr):
    return {mode: run_vac(PS, asr, SileroLikeVAD(device="cpu"), pipeline=mode)
            for mode in (False, True)}


def test_golden_vac_row(asr, port_runs):
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        row = json.load(f)["matrix"]["vac"]
    pieces, _ = port_runs[False]
    assert {"text": asr.sep.join(pieces).strip(), "commits": len(pieces)} == row


def test_exact_pipeline_commits_the_synchronous_words(port_runs):
    (sync_pieces, sync_words), (piped, piped_words) = port_runs[False], port_runs[True]
    assert piped_words == sync_words and sync_words
    assert "".join(piped) == "".join(sync_pieces)


@pytest.fixture(scope="module")
def jax_asr():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden as G

    return G.build_asr()


@pytest.mark.parametrize("policy", ["agree2", "last"])
def test_async_pipeline_commits_the_jax_packages_words(asr, jax_asr, policy):
    ours = run_vac(PS, asr, SileroLikeVAD(device="cpu"), "async", policy)
    ref = run_vac(JS, jax_asr, JaxSileroLikeVAD(), "async", policy)
    assert ours == ref
    assert ours[1]


def test_an_utterance_start_drops_the_inflight_draft(asr, monkeypatch):
    """Async under policy "last": each utterance's first dispatch after
    ``online.init`` has no device draft (the dropped tick's packed result
    never reaches the next utterance), later ones do."""
    calls = []
    dispatch, init = asr.transcribe_dispatch, PS.OnlineASRProcessor.init

    def recording(*args, device_draft=None, **kw):
        calls.append(device_draft)
        return dispatch(*args, device_draft=device_draft, **kw)

    def marking_init(self, offset=None):
        calls.append("init")
        init(self, offset)

    monkeypatch.setattr(asr, "transcribe_dispatch", recording)
    monkeypatch.setattr(PS.OnlineASRProcessor, "init", marking_init)
    run_vac(PS, asr, SileroLikeVAD(device="cpu"), "async", "last")
    firsts = [calls[i + 1] for i, c in enumerate(calls[:-1])
              if c == "init" and calls[i + 1] != "init"]
    assert calls.count("init") >= 3 and len(firsts) >= 2
    assert all(d is None for d in firsts)
    assert any(isinstance(c, dict) for c in calls)
