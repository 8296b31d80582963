"""Write the machine-readable quality-acceptance artifact from the golden fixture.

    python -m realtime_whisper_asr_tpu_torch.tools.run_eval [--out EVAL.json] \\
        [--checkpoint DIR] [--cpu]

Port of the JAX package's ``tools/run_eval.py``. Runs the committed golden
fixture (``tests/fixtures/golden``: the test-tiny weights ``params.npz`` and
the recorded ``transcripts.json``) through the port at f32 on the card
(``--cpu``: on the CPU) and records:

- per clip: whether the offline token ids and the streaming commits
  reproduce the recorded ones, and the streaming-vs-offline WER;
- the feature-surface matrix: each recorded row (beam 5, translate, the
  > 30 s window, ``int8-all``, the pre-quantized artifact, ``int4``, VAC,
  the pipelined loops, diarization) replayed and compared;
- the WER/CER harness self-checks.

The fixture's weights are random, so WER against human references is not
meaningful: the artifact locks decode determinism and the measurement
machinery. ``--checkpoint DIR`` adds offline runs of a real checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

SR = 16000
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "golden")


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """The fixture's deterministic synthetic speech-ish clip ``idx`` (as the
    recording script draws it)."""
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


def golden_vac_audio() -> np.ndarray:
    """Two VAD-detectable utterances separated by silence."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech

    rng = np.random.default_rng(2024)
    a, _ = synth_speech(rng, 3.0)
    b, _ = synth_speech(rng, 3.0)
    gap = np.zeros(int(1.2 * SR), np.float32)
    lead = np.zeros(int(0.4 * SR), np.float32)
    return np.concatenate([lead, a, gap, b, gap]).astype(np.float32)


def build_asr(device, quantization: str | None = None, **kw):
    """The port's ASR on the fixture's weights at f32, 24-token caps."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device=device,
                          params=load_flat_npz(os.path.join(FIXTURE_DIR, "params.npz")),
                          quantization=quantization, **kw)
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never EOT
    return asr


def run_clips(asr) -> list[dict]:
    """Offline + streaming results for the three golden clips."""
    from realtime_whisper_asr_tpu_torch.eval import wer
    from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

    clips = []
    for idx in range(3):
        audio = golden_audio(idx)
        offline = asr.transcribe(audio)
        offline_text = "".join(s.text for s in offline).strip()
        proc = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0))
        asr.set_active_stream(f"golden{idx}")
        pieces = []
        for pos in range(0, len(audio), SR):
            proc.insert_audio_chunk(audio[pos: pos + SR])
            _, _, txt = proc.process_iter()
            if txt:
                pieces.append(txt)
        _, _, txt = proc.finish()
        if txt:
            pieces.append(txt)
        streaming_text = asr.sep.join(pieces).strip()
        clips.append({"idx": idx, "offline_tokens": [int(t) for t in offline.tokens],
                      "offline_text": offline_text, "streaming_text": streaming_text,
                      "agreement_wer": round(wer(offline_text, streaming_text), 4)})
    return clips


def _row(res) -> dict:
    return {"tokens": [int(t) for t in res.tokens], "text": "".join(s.text for s in res).strip()}


def _pipelined_rows(device) -> dict:
    """The synchronous, exact and async loops under prefix policy "last"
    over the three clips: committed words, exact == sync, async's divergence."""
    from realtime_whisper_asr_tpu_torch.eval import wer
    from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

    asr = build_asr(device)

    def stream(audio, key, pipeline):
        proc = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0),
                                  prefix_policy="last", pipeline=pipeline)
        asr.set_active_stream(key)
        for pos in range(0, len(audio), SR):
            proc.insert_audio_chunk(audio[pos: pos + SR])
            proc.process_iter()
        proc.finish()
        return [[round(float(b), 3), round(float(e), 3), w] for b, e, w in proc.commited]

    sync_c, exact_c, async_c = [], [], []
    for i in range(3):
        audio = golden_audio(i)
        sync_c.append(stream(audio, f"pl_sync{i}", False))
        exact_c.append(stream(audio, f"pl_exact{i}", True))
        async_c.append(stream(audio, f"pl_async{i}", "async"))
    divergence = []
    for s, a in zip(sync_c, async_c):
        st = asr.sep.join(w for _, _, w in s).strip()
        at = asr.sep.join(w for _, _, w in a).strip()
        divergence.append({"commit_wer_vs_sync": round(wer(st, at), 4),
                           "final_equal_vs_sync": st == at})
    return {"pipeline_exact": {"commits": exact_c, "matches_sync": exact_c == sync_c},
            "pipeline_async": {"commits": async_c, "sync_commits": sync_c,
                               "divergence": divergence}}


def run_matrix(device) -> dict:
    """Every row of the fixture's feature-surface matrix, through the port."""
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.speaker import SpeakerTracker
    from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import (
        sample_speaker,
        synth_speaker_utterance,
    )
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import save_checkpoint
    from realtime_whisper_asr_tpu_torch.streaming import (
        OnlineASRProcessor,
        VACOnlineASRProcessor,
        VADIterator,
    )

    import torch

    rows: dict = {}
    audio = golden_audio(0)
    rows["beam5"] = _row(build_asr(device, beam_size=5).transcribe(audio))
    asr = build_asr(device)
    asr.set_translate_task()
    rows["translate"] = _row(asr.transcribe(audio))
    long_audio = np.concatenate([golden_audio(i) for i in range(5)])  # 40 s
    rows["long_window"] = _row(build_asr(device).transcribe(long_audio))

    asr8 = build_asr(device, quantization="int8-all")
    rows["int8all"] = _row(asr8.transcribe(audio))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, asr8.model.state_dict(), asr8.cfg)
        asr_pq = TorchWhisperASR(checkpoint_dir=d, dtype=torch.float32, device=device)
        asr_pq.transcribe_kargs["max_total_tokens"] = 24
        pq = _row(asr_pq.transcribe(audio))
    rows["prequant"] = dict(pq, matches_int8all=pq["tokens"] == rows["int8all"]["tokens"])
    rows["int4"] = _row(build_asr(device, quantization="int4").transcribe(audio))

    asr = build_asr(device)
    vac = VACOnlineASRProcessor(
        OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0)),
        VADIterator(SileroLikeVAD(device=device), threshold=0.5,
                    min_silence_duration_ms=500, speech_pad_ms=100),
        online_chunk_size=0.5)
    vaudio, pieces = golden_vac_audio(), []
    for pos in range(0, len(vaudio), SR // 2):
        vac.insert_audio_chunk(vaudio[pos: pos + SR // 2])
        _, _, txt = vac.process_iter()
        if txt:
            pieces.append(txt)
    _, _, txt = vac.finish()
    if txt:
        pieces.append(txt)
    rows["vac"] = {"text": asr.sep.join(pieces).strip(), "commits": len(pieces)}
    rows.update(_pipelined_rows(device))

    rng = np.random.default_rng(31)
    spk_a, spk_b = sample_speaker(rng), sample_speaker(rng)
    tracker, labels = SpeakerTracker(), []
    for i in range(6):
        utt = synth_speaker_utterance(rng, spk_a if i % 2 == 0 else spk_b, seconds=2.0)
        labels.append(int(tracker.assign(utt.astype(np.float32))[0]))
    rows["diarize"] = {"labels": labels, "turns": int(tracker.turns)}
    return rows


def _matches(key: str, recorded: dict, current: dict) -> bool:
    """A matrix row reproduced; the async row by its commits (its note and
    any other text field are the recording's prose)."""
    if key == "pipeline_async":
        return all(current[k] == recorded[k] for k in ("commits", "sync_commits", "divergence"))
    return current == recorded


def evaluate(device, checkpoint: str | None = None) -> dict:
    from realtime_whisper_asr_tpu_torch.eval import cer, evaluate_offline, wer

    with open(os.path.join(FIXTURE_DIR, "transcripts.json")) as f:
        recorded = json.load(f)
    clips = run_clips(build_asr(device))
    entries = [{
        "clip": rec["idx"],
        "offline_tokens_reproduced": cur["offline_tokens"] == rec["offline_tokens"],
        "streaming_commits_reproduced": cur["streaming_text"] == rec["streaming_text"],
        "streaming_vs_offline_wer": cur["agreement_wer"],
        "offline_tokens": len(cur["offline_tokens"]),
    } for rec, cur in zip(recorded["clips"], clips)]
    current = run_matrix(device)
    matrix = [{"row": k, "reproduced": _matches(k, rec, current[k])}
              for k, rec in recorded["matrix"].items()]
    out = {
        "model": recorded["model"],
        "device": str(device),
        "fixture": "tests/fixtures/golden (committed checkpoint + transcripts)",
        "clips": entries,
        "matrix": matrix,
        "all_reproduced": all(e["offline_tokens_reproduced"] and e["streaming_commits_reproduced"]
                              for e in entries) and all(m["reproduced"] for m in matrix),
        "harness_selfcheck": {"wer_identity": wer("a b c", "a b c"),
                              "wer_one_sub": wer("a b c", "a x c"),
                              "cer_identity": cer("abc", "abc")},
        "note": ("random-init weights (no network): WER vs human references is not "
                 "meaningful; this artifact locks decode determinism + the WER/CER "
                 "machinery. Pass --checkpoint for true quality numbers."),
    }
    if checkpoint:
        from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR

        real = TorchWhisperASR(checkpoint_dir=checkpoint, device=device)
        manifest = [(f"golden{i}", golden_audio(i), "") for i in range(3)]
        out["checkpoint_runs"] = [
            {"name": r.name, "hyp": r.hypothesis, "rtf": r.wall_seconds / r.audio_seconds}
            for r in evaluate_offline(real, manifest)]
    return out


def main(argv=None) -> int:
    from realtime_whisper_asr_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="EVAL_torch.json")
    ap.add_argument("--checkpoint", default=None,
                    help="optional real checkpoint dir for true WER runs")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)
    out = evaluate(resolve_device("cpu" if args.cpu else "cuda"), args.checkpoint)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"all_reproduced": out["all_reproduced"], "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
