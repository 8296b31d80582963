"""The port's speaker stages against the golden row and the JAX package.

- The golden ``diarize`` row of ``tests/fixtures/golden/transcripts.json``
  (labels and turns over six alternating synthetic speakers, seed 31),
  reproduced exactly by the port's ``SpeakerTracker`` on the packaged
  weights.
- Utterance features and embeddings equal the JAX package's bit for bit
  (both are the same numpy code over the same mel filterbank).
- ``StreamServer(diarize=True)``: two VAC streams of alternating speakers
  (the Silero-like VAD of each package, the port's on the CPU; the
  streaming tests' timecoded fake ASR) get the JAX server's results and
  speaker labels, result for result.
- The app's diarization hooks: turn events and labeled results as in the
  JAX app's test.
"""

import json
import os

import numpy as np
import pytest

import realtime_whisper_asr_tpu.serving as JSV
import realtime_whisper_asr_tpu_torch.serving as PSV
from realtime_whisper_asr_tpu.models import speaker as JSP
from realtime_whisper_asr_tpu.models.vad import SileroLikeVAD as JaxSileroLikeVAD
from realtime_whisper_asr_tpu_torch.models import speaker as PSP
from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD
from realtime_whisper_asr_tpu_torch.models.vad.synthetic import (
    sample_speaker,
    synth_speaker_utterance,
)
from tests.test_streaming import TimecodedFakeASR, make_words

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000


def test_golden_diarize_row_reproduced():
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        row = json.load(f)["matrix"]["diarize"]
    rng = np.random.default_rng(31)
    spk_a, spk_b = sample_speaker(rng), sample_speaker(rng)
    tracker = PSP.SpeakerTracker()
    assert tracker.embedder.trained
    labels = []
    for i in range(6):
        utt = synth_speaker_utterance(rng, spk_a if i % 2 == 0 else spk_b, seconds=2.0)
        sid, _ = tracker.assign(utt.astype(np.float32))
        labels.append(int(sid))
    assert {"labels": labels, "turns": int(tracker.turns)} == row


def test_features_and_embeddings_equal_jax():
    rng = np.random.default_rng(5)
    emb_port, emb_jax = PSP.SpeakerEmbedder(), JSP.SpeakerEmbedder()
    for k in range(4):
        utt = synth_speaker_utterance(rng, sample_speaker(rng), seconds=1.0 + 0.5 * k)
        utt = utt.astype(np.float32)
        np.testing.assert_array_equal(PSP.utterance_features(utt), JSP.utterance_features(utt))
        np.testing.assert_array_equal(emb_port(utt), emb_jax(utt))
    np.testing.assert_array_equal(PSP._mel_matrix(), JSP._mel_matrix())
    assert emb_port.threshold == emb_jax.threshold


def _alternating(seed, turns=4, utt_s=2.0, gap_s=1.0):
    rng = np.random.default_rng(seed)
    a, b = sample_speaker(rng), sample_speaker(rng)
    gap = (0.002 * rng.standard_normal(int(gap_s * SR))).astype(np.float32)
    pieces = []
    for turn in range(turns):
        utt = synth_speaker_utterance(rng, a if turn % 2 == 0 else b, seconds=utt_s)
        pieces += [utt * (0.5 / (np.abs(utt).max() + 1e-6)), gap.copy()]
    return np.concatenate(pieces).astype(np.float32)


def _serve(S, vad, audios):
    server = S.StreamServer(TimecodedFakeASR(make_words(40), unstable_tail=False),
                            vad_factory=vad, use_vad=True, diarize=True,
                            online_chunk_size=0.5, min_silence_duration_ms=300,
                            clock=lambda: 0.0)
    sids = [server.create_stream() for _ in audios]
    outs = {sid: [] for sid in sids}
    for pos in range(0, len(audios[0]), SR // 2):
        for sid, audio in zip(sids, audios):
            server.feed(sid, audio[pos : pos + SR // 2])
        while server.step():
            pass
        for sid in sids:
            outs[sid].extend(server.poll(sid))
    stats = [server.streams[sid].diarizer.get_stats() for sid in sids]
    for sid in sids:
        outs[sid].extend(server.close_stream(sid))
    return [[(round(r.begin, 3), round(r.end, 3), r.text, r.speaker) for r in outs[sid]]
            for sid in sids], stats


def test_server_diarize_labels_equal_jax():
    audios = [_alternating(23), _alternating(41)]
    got, got_stats = _serve(PSV, lambda: SileroLikeVAD(device="cpu"), audios)
    want, want_stats = _serve(JSV, JaxSileroLikeVAD, audios)
    assert got == want
    assert got_stats == want_stats
    for rows, st in zip(got, got_stats):
        assert {r[3] for r in rows} >= {"S1", "S2"}, rows
        assert st["utterances"] == 4 and st["speakers"] == 2 and st["turns"] == 3, st


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_app_speaker_turn_hooks(pkg):
    """StreamingApp with diarization on: alternating speakers separated by
    silence give turn events and [S<n>]-labeled results; the port's lines
    equal the JAX app's."""
    from realtime_whisper_asr_tpu.app import SessionStats as JStats
    from realtime_whisper_asr_tpu.app import StreamingApp as JApp
    from realtime_whisper_asr_tpu.config import ConfigManager as JCM
    from realtime_whisper_asr_tpu_torch.app import SessionStats as PStats
    from realtime_whisper_asr_tpu_torch.app import StreamingApp as PApp
    from realtime_whisper_asr_tpu_torch.config import ConfigManager as PCM

    audio = _alternating(19, gap_s=1.0)
    runs = {}
    for name, App, CM, Stats, kw in (("jax", JApp, JCM, JStats, {}),
                                     ("torch", PApp, PCM, PStats, {"device": "cpu"})):
        cm = CM(autoload=False)
        cm.set("diarization.enable", True)
        cm.set("vad.min_silence_duration_ms", 300)
        cm.set("audio_deduplication.enable", False)
        cm.set("performance.display_interval_s", 1e9)
        lines = []
        app = App(config=cm, asr=TimecodedFakeASR(make_words(40), unstable_tail=False),
                  output=lines.append, clock=lambda: 0.0, **kw)
        stats = Stats()
        for pos in range(0, len(audio), SR // 2):
            app.process_chunk(audio[pos : pos + SR // 2], stats, 0.0)
        app.output.flush()
        app.shutdown()
        runs[name] = (lines, app.diarizer.get_stats(), stats)
    lines, st, _ = runs[pkg]
    assert st["utterances"] >= 3 and st["speakers"] >= 2, st
    assert any("🗣" in line for line in lines), lines
    assert any("[S2]" in line for line in lines), lines
    assert runs["torch"][0] == runs["jax"][0]
    assert runs["torch"][1] == runs["jax"][1]
    assert runs["torch"][2].__dict__ == runs["jax"][2].__dict__
