"""Subtitle / transcript serialization: SRT, WebVTT, JSON, plain text.

Port of ``realtime_whisper_asr_tpu/io/subtitles.py`` (JAX-free there
too; the port keeps its own copy). The reference prints transcripts to the
console only; offline users of faster-whisper expect subtitle export from a
file transcription (the capability CTranslate2-based CLIs ship). Segments
are the asr.Segment protocol objects (start / end / text / words).
"""

from __future__ import annotations

import json
from typing import Sequence


def _ts(seconds: float, sep: str) -> str:
    if seconds < 0:
        seconds = 0.0
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def to_srt(segments: Sequence) -> str:
    """SubRip: 1-indexed cues, ``HH:MM:SS,mmm --> HH:MM:SS,mmm``."""
    lines = []
    n = 0
    for seg in segments:
        text = seg.text.strip()
        if not text:
            continue
        n += 1
        lines.append(str(n))
        lines.append(f"{_ts(seg.start, ',')} --> {_ts(max(seg.end, seg.start), ',')}")
        lines.append(text)
        lines.append("")
    return "\n".join(lines)


def to_vtt(segments: Sequence) -> str:
    """WebVTT: ``WEBVTT`` header, ``HH:MM:SS.mmm --> HH:MM:SS.mmm`` cues."""
    lines = ["WEBVTT", ""]
    for seg in segments:
        text = seg.text.strip()
        if not text:
            continue
        lines.append(f"{_ts(seg.start, '.')} --> {_ts(max(seg.end, seg.start), '.')}")
        lines.append(text)
        lines.append("")
    return "\n".join(lines)


def to_json(segments: Sequence) -> str:
    """JSON: segments with word-level times when available."""
    out = []
    for seg in segments:
        out.append({
            "start": round(seg.start, 3),
            "end": round(seg.end, 3),
            "text": seg.text,
            "words": [
                {"start": round(w.start, 3), "end": round(w.end, 3), "word": w.word}
                for w in getattr(seg, "words", [])
            ],
        })
    return json.dumps({"segments": out}, ensure_ascii=False, indent=2)


def to_txt(segments: Sequence) -> str:
    return "\n".join(s.text.strip() for s in segments if s.text.strip())


FORMATTERS = {"srt": to_srt, "vtt": to_vtt, "json": to_json, "txt": to_txt}


def format_segments(segments: Sequence, fmt: str) -> str:
    try:
        return FORMATTERS[fmt](segments)
    except KeyError:
        raise ValueError(f"unknown subtitle format {fmt!r} (one of {sorted(FORMATTERS)})")
