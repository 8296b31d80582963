"""Re-fit detection thresholds from a labeled audio directory.

    python -m realtime_whisper_asr_tpu_torch.tools.calibrate DIR \\
        [--out calibration.json] [--write-config config.json] [--cpu]
    python -m realtime_whisper_asr_tpu_torch.tools.calibrate DIR --synth [--seed 0]

Port of the JAX package's ``tools/calibrate.py``. It re-fits the VAD
threshold, the speaker equal-error threshold and the audio-dedup thresholds
from any labeled directory (``--synth`` first writes one from the synthetic
generators) and writes a calibration JSON and, optionally, the config
overrides (``config.ConfigManager``, at the keys the runtime reads). The
Silero-like VAD runs on the card unless ``--cpu`` is given; without CUDA
and without ``--cpu`` the tool raises. The speaker embedder and the dedup
features are the port's numpy code.

Labeled directory layout (JSONL manifests; every wav 16 kHz mono f32/s16):

  vad.jsonl       {"wav": "clip1.wav", "speech": [[0.4, 1.9], [2.5, 3.1]]}
                  speech spans in seconds; everything else is non-speech
  speakers.jsonl  {"wav": "utt1.wav", "speaker": "alice"}
                  one utterance per line; >= 2 utterances per speaker
  dedup.jsonl     {"wav_a": "a.wav", "wav_b": "b.wav", "duplicate": true}
                  chunk pairs labeled duplicate / distinct

Any manifest may be absent: only the present ones are calibrated.

Fitting rules:
  - VAD: the threshold maximizing the balanced accuracy of per-frame speech
    classification (ROC AUC reported beside it)
  - speaker: the equal-error-rate threshold over all same/different
    embedding pairs (the criterion ``tools/train_speaker.py`` ships)
  - dedup: similarity_threshold at the equal-error point of duplicate vs
    distinct relative similarity; duplicate_threshold just above the
    highest distinct pair's similarity (nothing labeled distinct is ever
    hard-dropped)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SR = 16000
FRAME = 512


def _read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if not n_pos or not n_neg:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _eer_threshold(same: np.ndarray, diff: np.ndarray) -> tuple[float, float]:
    """The threshold where the false-accept rate is closest to the
    false-reject rate (same above, diff below = correct) -> (threshold,
    equal error rate)."""
    cands = np.unique(np.concatenate([same, diff]))
    best_t, best_gap, eer = float(cands[0]), np.inf, 1.0
    for t in cands:
        frr = float((same < t).mean())  # same-pair rejected
        far = float((diff >= t).mean())  # diff-pair accepted
        if abs(frr - far) < best_gap:
            best_t, best_gap, eer = float(t), abs(frr - far), (frr + far) / 2
    return best_t, eer


def calibrate_vad(entries: list[dict], root: str, device="cuda") -> dict:
    """The VAD threshold of best balanced accuracy over the labeled frames;
    one Silero-like VAD on ``device``, its state reset for each clip."""
    from realtime_whisper_asr_tpu_torch.io import read_wav
    from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD

    vad = SileroLikeVAD(device=device)
    scores, labels = [], []
    for e in entries:
        audio = read_wav(os.path.join(root, e["wav"]))
        n_frames = len(audio) // FRAME
        if not n_frames:
            continue
        frames = audio[: n_frames * FRAME].reshape(n_frames, FRAME)
        vad.reset()
        scores.append(np.asarray(vad(frames), np.float64))
        lab = np.zeros(n_frames, np.float64)
        t = (np.arange(n_frames) + 0.5) * FRAME / SR
        for beg, end in e.get("speech", []):
            lab[(t >= beg) & (t < end)] = 1.0
        labels.append(lab)
    s, l = np.concatenate(scores), np.concatenate(labels)
    cands = np.linspace(0.05, 0.95, 91)
    bal = [
        0.5 * (((s >= c) & (l > 0.5)).sum() / max((l > 0.5).sum(), 1))
        + 0.5 * (((s < c) & (l <= 0.5)).sum() / max((l <= 0.5).sum(), 1))
        for c in cands
    ]
    best = int(np.argmax(bal))
    return {
        "threshold": round(float(cands[best]), 3),
        "balanced_accuracy": round(float(bal[best]), 4),
        "auc": round(_auc(s, l), 4),
        "frames": int(len(l)),
        "config_key": "vad.threshold",
    }


def calibrate_speaker(entries: list[dict], root: str) -> dict:
    from realtime_whisper_asr_tpu_torch.io import read_wav
    from realtime_whisper_asr_tpu_torch.models.speaker import SpeakerEmbedder

    emb = SpeakerEmbedder()
    vecs, who = [], []
    for e in entries:
        vecs.append(emb(read_wav(os.path.join(root, e["wav"]))))
        who.append(e["speaker"])
    vecs = np.stack(vecs)
    same, diff = [], []
    for i in range(len(vecs)):
        for j in range(i + 1, len(vecs)):
            (same if who[i] == who[j] else diff).append(float(vecs[i] @ vecs[j]))
    t, eer = _eer_threshold(np.asarray(same), np.asarray(diff))
    return {
        "threshold": round(t, 4),
        "eer": round(eer, 4),
        "same_pairs": len(same),
        "diff_pairs": len(diff),
        "config_key": "diarization.threshold",
    }


def calibrate_dedup(entries: list[dict], root: str) -> dict:
    from realtime_whisper_asr_tpu_torch.io import read_wav
    from realtime_whisper_asr_tpu_torch.ops.features import relative_similarity
    from realtime_whisper_asr_tpu_torch.pipeline.dedup_audio import _features_numpy

    dup, dis = [], []
    for e in entries:
        fa = _features_numpy(read_wav(os.path.join(root, e["wav_a"])))
        fb = _features_numpy(read_wav(os.path.join(root, e["wav_b"])))
        sim = relative_similarity(fa, fb)
        (dup if e["duplicate"] else dis).append(sim)
    dup_a, dis_a = np.asarray(dup), np.asarray(dis)
    t, eer = _eer_threshold(dup_a, dis_a)
    return {
        "similarity_threshold": round(t, 4),
        "duplicate_threshold": round(min(float(dis_a.max()) + 1e-4, 0.9999), 4)
        if len(dis_a) else 0.98,
        "eer": round(eer, 4),
        "duplicate_pairs": len(dup),
        "distinct_pairs": len(dis),
        "config_keys": ["audio_deduplication.similarity_threshold",
                        "audio_deduplication.duplicate_threshold"],
    }


def write_synthetic_dir(out_dir: str, seed: int = 0, n_clips: int = 12,
                        n_speakers: int = 6, utts: int = 3) -> None:
    """A labeled directory from the synthetic generators (the JAX tool's,
    draw for draw)."""
    from realtime_whisper_asr_tpu_torch.io import write_wav
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import (
        sample_speaker,
        synth_example,
        synth_nonspeech,
        synth_speaker_utterance,
    )

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, "vad.jsonl"), "w") as f:
        for i in range(n_clips):
            audio, labels = synth_example(rng, 4.0)
            name = f"vad_{i}.wav"
            write_wav(os.path.join(out_dir, name), audio)
            # frame labels -> merged speech spans
            spans, beg = [], None
            for k, v in enumerate(labels):
                if v > 0.5 and beg is None:
                    beg = k * FRAME / SR
                elif v <= 0.5 and beg is not None:
                    spans.append([round(beg, 3), round(k * FRAME / SR, 3)])
                    beg = None
            if beg is not None:
                spans.append([round(beg, 3), round(len(labels) * FRAME / SR, 3)])
            f.write(json.dumps({"wav": name, "speech": spans}) + "\n")

    with open(os.path.join(out_dir, "speakers.jsonl"), "w") as f:
        for s in range(n_speakers):
            spk = sample_speaker(rng)
            for u in range(utts):
                name = f"spk{s}_utt{u}.wav"
                write_wav(os.path.join(out_dir, name),
                          synth_speaker_utterance(rng, spk, seconds=1.6))
                f.write(json.dumps({"wav": name, "speaker": f"spk{s}"}) + "\n")

    with open(os.path.join(out_dir, "dedup.jsonl"), "w") as f:
        for i in range(n_clips):
            base, _ = synth_example(rng, 1.0)
            while float(np.sqrt(np.mean(base**2))) < 0.01:  # skip near-silence
                base, _ = synth_example(rng, 1.0)
            a = f"dd_{i}_a.wav"
            write_wav(os.path.join(out_dir, a), base)
            # duplicate = the same audio + light noise (a re-captured chunk);
            # distinct = a fresh clip, alternating speech-mix and pure noise
            if i % 2 == 0:
                rms = float(np.sqrt(np.mean(base**2)))
                dup = base + (0.01 * rms) * rng.standard_normal(len(base)).astype(np.float32)
                b = f"dd_{i}_b.wav"
                write_wav(os.path.join(out_dir, b), dup)
                f.write(json.dumps({"wav_a": a, "wav_b": b, "duplicate": True}) + "\n")
            else:
                other = (synth_example(rng, 1.0)[0] if i % 4 == 1
                         else synth_nonspeech(rng, 1.0))
                b = f"dd_{i}_b.wav"
                write_wav(os.path.join(out_dir, b), np.asarray(other, np.float32))
                f.write(json.dumps({"wav_a": a, "wav_b": b, "duplicate": False}) + "\n")


def calibrate_dir(root: str, device="cuda") -> dict:
    """Every present manifest's calibration, the VAD's on ``device``."""
    out: dict = {}
    for name, manifest, fit in (
            ("vad", "vad.jsonl", lambda e: calibrate_vad(e, root, device)),
            ("speaker", "speakers.jsonl", lambda e: calibrate_speaker(e, root)),
            ("dedup", "dedup.jsonl", lambda e: calibrate_dedup(e, root))):
        path = os.path.join(root, manifest)
        if os.path.exists(path):
            out[name] = fit(_read_jsonl(path))
    return out


def main(argv=None) -> int:
    from realtime_whisper_asr_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", help="labeled directory (see the module's docstring)")
    ap.add_argument("--out", default=None, help="calibration JSON output path")
    ap.add_argument("--write-config", default=None,
                    help="config.json to write the fitted thresholds into")
    ap.add_argument("--synth", action="store_true",
                    help="generate a synthetic labeled corpus into DIR first")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the VAD on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    if args.synth:
        write_synthetic_dir(args.dir, seed=args.seed)
        print(f"synthetic labeled corpus written to {args.dir}")

    cal = calibrate_dir(args.dir, device)
    if not cal:
        print("no vad.jsonl / speakers.jsonl / dedup.jsonl found", file=sys.stderr)
        return 2
    print(json.dumps(cal, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cal, f, indent=2)
    if args.write_config:
        from realtime_whisper_asr_tpu_torch.config import ConfigManager

        cm = ConfigManager(args.write_config, autoload=True)
        if "vad" in cal:
            cm.set("vad.threshold", cal["vad"]["threshold"])
        if "speaker" in cal:
            cm.set("diarization.threshold", cal["speaker"]["threshold"])
        if "dedup" in cal:
            cm.set("audio_deduplication.similarity_threshold",
                   cal["dedup"]["similarity_threshold"])
            cm.set("audio_deduplication.duplicate_threshold",
                   cal["dedup"]["duplicate_threshold"])
        cm.save_config()
        print(f"thresholds written to {args.write_config}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
