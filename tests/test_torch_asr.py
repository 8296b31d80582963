"""The port's ASR backend and streaming loop against the committed golden
transcripts (tests/fixtures/golden/transcripts.json, which the JAX package
reproduces exactly in tests/test_golden.py).

The port loads the same test-tiny weights, runs at f32 on the CPU, and must
reproduce each clip's offline tokens and text, its streaming text through
the port's OnlineASRProcessor at 1 s chunks, the offline-vs-streaming
agreement WER, and the ``translate`` and ``long_window`` rows of the
feature matrix.
"""

import json
import os

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.eval import wer
from realtime_whisper_asr_tpu.models.whisper import timestamps as jax_timestamps
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import timestamps
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
SR = 16000


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """tools/golden.py's deterministic synthetic clips."""
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


@pytest.fixture(scope="module")
def recorded():
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def state():
    return load_flat_npz(os.path.join(GOLDEN, "params.npz"))


def build_asr(state) -> TorchWhisperASR:
    asr = TorchWhisperASR(cfg=get_config("test-tiny"), params=state, dtype=torch.float32,
                          device="cpu")
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    return asr


@pytest.fixture(scope="module")
def clips(state):
    """tools/golden.py's run_clips on the port: offline + streaming per clip."""
    asr = build_asr(state)
    out = []
    for idx in range(3):
        audio = golden_audio(idx)
        offline = asr.transcribe(audio)
        offline_text = "".join(s.text for s in offline).strip()
        proc = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0))
        pieces = []
        for pos in range(0, len(audio), SR):
            proc.insert_audio_chunk(audio[pos : pos + SR])
            _, _, txt = proc.process_iter()
            if txt:
                pieces.append(txt)
        _, _, txt = proc.finish()
        if txt:
            pieces.append(txt)
        streaming_text = asr.sep.join(pieces).strip()
        out.append({
            "offline_tokens": offline.tokens,
            "offline_text": offline_text,
            "streaming_text": streaming_text,
            "agreement_wer": round(wer(offline_text, streaming_text), 4),
        })
    return asr, out


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_offline_tokens_and_text_equal_golden(recorded, clips, idx):
    rec, cur = recorded["clips"][idx], clips[1][idx]
    assert cur["offline_tokens"] == rec["offline_tokens"]
    assert cur["offline_text"] == rec["offline_text"]


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_streaming_text_equals_golden(recorded, clips, idx):
    assert clips[1][idx]["streaming_text"] == recorded["clips"][idx]["streaming_text"]


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_agreement_wer_equals_golden(recorded, clips, idx):
    assert clips[1][idx]["agreement_wer"] == pytest.approx(
        recorded["clips"][idx]["agreement_wer"], abs=1e-6)


def test_counters_one_upload_per_tick(clips):
    """One host→device copy a tick, and one a streaming insert: the online
    processor prefetches each grown buffer into the device ring
    (``asr.prefetch_audio``), so a streaming tick's own copy carries only
    the aux bundle."""
    asr = clips[0]
    ticks = 3 * (1 + 8)  # per clip: one offline window + eight 1 s streaming ticks
    inserts = 3 * 8
    assert asr.counters["ticks"] == ticks
    assert asr.counters["h2d_transfers"] == ticks + inserts


def _row(res) -> dict:
    return {"tokens": [int(t) for t in res.tokens], "text": "".join(s.text for s in res).strip()}


def test_translate_row_equals_golden(recorded, state):
    asr = build_asr(state)
    asr.set_translate_task()
    assert _row(asr.transcribe(golden_audio(0))) == recorded["matrix"]["translate"]


def test_long_window_row_equals_golden(recorded, state):
    """> 30 s input: sequential windows, each carrying the previous
    window's text as its prompt."""
    asr = build_asr(state)
    long_audio = np.concatenate([golden_audio(i) for i in range(5)])  # 40 s
    assert _row(asr.transcribe(long_audio)) == recorded["matrix"]["long_window"]
    assert asr.counters["ticks"] >= 2


def test_dtw_and_median_filter_equal_jax_package():
    rng = np.random.default_rng(5)
    cost = rng.standard_normal((12, 40))
    for ours, ref in zip(timestamps.dtw_path(cost), jax_timestamps.dtw_path(cost)):
        np.testing.assert_array_equal(ours, ref)
    x = rng.standard_normal((3, 50))
    np.testing.assert_array_equal(timestamps.median_filter(x, 7),
                                  jax_timestamps.median_filter(x, 7))
