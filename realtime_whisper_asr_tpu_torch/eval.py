"""Transcript quality evaluation: WER/CER and streaming-vs-offline agreement.

Port of ``realtime_whisper_asr_tpu/eval.py`` (numpy only there too; the port
keeps its own copy). The acceptance for this system is "transcripts matching
faster-whisper reference output". This module provides the measurement:
word/character error rate with the standard normalization, plus a harness
that runs a (wav, reference-text) manifest through the offline and streaming
paths of any backend (``TorchWhisperASR`` on the card or the CPU) and
reports WER and latency together.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Iterable, Optional

import numpy as np


def normalize_text(s: str) -> str:
    """Lowercase, strip punctuation, collapse whitespace (the standard English
    normalization subset; language-specific normalizers can wrap this)."""
    s = s.lower()
    s = re.sub(r"[^\w\s']", " ", s, flags=re.UNICODE)
    return " ".join(s.split())


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein over token lists, two-row DP."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i]
        for j, h in enumerate(hyp, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h)))
        prev = cur
    return prev[-1]


def wer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    ref = (normalize_text(reference) if normalize else reference).split()
    hyp = (normalize_text(hypothesis) if normalize else hypothesis).split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def cer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    ref = list(normalize_text(reference) if normalize else reference)
    hyp = list(normalize_text(hypothesis) if normalize else hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


@dataclasses.dataclass
class EvalResult:
    name: str
    wer: float
    cer: float
    hypothesis: str
    reference: str
    audio_seconds: float
    wall_seconds: float
    p50_latency_ms: Optional[float] = None


def evaluate_offline(asr, manifest: Iterable[tuple[str, np.ndarray, str]]) -> list[EvalResult]:
    """manifest: (name, audio f32 16 kHz, reference text) triples."""
    out = []
    for name, audio, ref in manifest:
        t0 = time.perf_counter()
        segs = asr.transcribe(audio)
        wall = time.perf_counter() - t0
        hyp = "".join(s.text for s in segs).strip()
        out.append(EvalResult(name, wer(ref, hyp), cer(ref, hyp), hyp, ref,
                              len(audio) / 16000, wall))
    return out


def evaluate_streaming(
    make_processor, manifest: Iterable[tuple[str, np.ndarray, str]], chunk_seconds: float = 1.0
) -> list[EvalResult]:
    """Runs each manifest entry through a fresh online processor; WER measured
    on the concatenated committed stream + final flush."""
    out = []
    sr = 16000
    n = int(chunk_seconds * sr)
    for name, audio, ref in manifest:
        proc = make_processor()
        pieces, lat = [], []
        t0 = time.perf_counter()
        for pos in range(0, len(audio), n):
            proc.insert_audio_chunk(audio[pos : pos + n])
            ta = time.perf_counter()
            b, e, txt = proc.process_iter()
            lat.append(time.perf_counter() - ta)
            if txt:
                pieces.append(txt)
        b, e, txt = proc.finish()
        if txt:
            pieces.append(txt)
        wall = time.perf_counter() - t0
        sep = getattr(getattr(proc, "online", proc).asr, "sep", " ")
        hyp = sep.join(pieces).strip()
        out.append(EvalResult(
            name, wer(ref, hyp), cer(ref, hyp), hyp, ref, len(audio) / sr, wall,
            p50_latency_ms=float(np.percentile(lat, 50) * 1e3) if lat else None,
        ))
    return out


def report(results: list[EvalResult]) -> str:
    lines = []
    for r in results:
        lines.append(json.dumps({
            "name": r.name, "wer": round(r.wer, 4), "cer": round(r.cer, 4),
            "audio_s": round(r.audio_seconds, 1), "wall_s": round(r.wall_seconds, 2),
            "rtf": round(r.wall_seconds / max(r.audio_seconds, 1e-6), 4),
            "p50_ms": round(r.p50_latency_ms, 1) if r.p50_latency_ms else None,
        }))
    mean_wer = float(np.mean([r.wer for r in results])) if results else 0.0
    lines.append(json.dumps({"mean_wer": round(mean_wer, 4), "n": len(results)}))
    return "\n".join(lines)
