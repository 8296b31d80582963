"""Text-level dedup: skip repeated/similar recognitions in a sliding window.

Capability parity with the reference's ImprovedSkipDetector
(`improved_skip_detector.py:13-367`): exact duplicates, partial containment
(~80 % rules), "ABCABC…" repetition patterns, similarity ≥ threshold
(SequenceMatcher + normalized Levenshtein), all inside a time window — plus
the extension rule: if the new text extends the previous one, the previous
entry is replaced and the new text passes.

Clock injection keeps every decision deterministic under test (the reference
threads ``current_time`` through ``should_skip`` the same way).
"""

from __future__ import annotations

import time as _time
from difflib import SequenceMatcher
from typing import Callable, Optional


def levenshtein_ratio(a: str, b: str) -> float:
    """1 - dist/max_len, O(len(a)·len(b)) with two rows."""
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return 1.0 - prev[-1] / max(len(a), len(b))


def detect_repetition(text: str, min_repeats: int = 3) -> bool:
    """True for 'ABCABCABC…' style strings (period ≥1 repeated ≥min_repeats)
    or when one substring covers >60 % of the text (reference :112-145)."""
    s = text.strip()
    n = len(s)
    if n < min_repeats:
        return False
    for period in range(1, n // min_repeats + 1):
        unit = s[:period]
        repeats = n // period
        if repeats >= min_repeats and unit * repeats == s[: period * repeats] and period * repeats >= 0.9 * n:
            return True
    # dense-substring check on words
    words = s.split()
    if len(words) >= 4:
        from collections import Counter

        top = Counter(words).most_common(1)[0]
        if top[1] / len(words) > 0.6:
            return True
    return False


class SkipDetector:
    def __init__(
        self,
        similarity_threshold: float = 0.85,
        time_window_s: float = 10.0,
        min_length: int = 2,
        containment_threshold: float = 0.8,
        clock: Callable[[], float] = _time.time,
    ):
        self.similarity_threshold = similarity_threshold
        self.time_window_s = time_window_s
        self.min_length = min_length
        self.containment_threshold = containment_threshold
        self.clock = clock
        self.history: list[tuple[float, str]] = []  # (time, text)
        self.stats = {
            "total": 0,
            "skipped": 0,
            "exact_duplicate": 0,
            "partial_match": 0,
            "repetition": 0,
            "similar": 0,
            "too_short": 0,
            "extended": 0,
        }

    # ------------------------------------------------------------------ rules

    def _is_partial_match(self, new: str, old: str) -> bool:
        """Containment rules (reference :147-198): old ⊂ new (but new is not a
        strict extension) or new ⊂ old with ≥ containment ratio."""
        a, b = new.strip().lower(), old.strip().lower()
        if not a or not b:
            return False
        if a in b:
            # new is a fragment of something already emitted: no new info
            return True
        if b in a:
            # new contains old: skip only when barely longer (a real extension
            # was already intercepted by _is_extension and replaced history)
            return len(b) / len(a) >= self.containment_threshold
        return False

    def _is_extension(self, new: str, old: str) -> bool:
        """new strictly extends old with meaningful additional content."""
        a, b = new.strip(), old.strip()
        return len(a) > len(b) and a.lower().startswith(b.lower()) and len(a) - len(b) >= 2

    # ------------------------------------------------------------------- main

    def should_skip(self, text: str, current_time: Optional[float] = None) -> tuple[bool, str]:
        """(skip?, reason). Mutates history (window pruning, extension replace)."""
        now = self.clock() if current_time is None else current_time
        self.stats["total"] += 1
        t = text.strip()

        if len(t) < self.min_length:
            self.stats["skipped"] += 1
            self.stats["too_short"] += 1
            return True, "too_short"

        self.history = [(ts, h) for ts, h in self.history if now - ts <= self.time_window_s]

        if detect_repetition(t):
            self.stats["skipped"] += 1
            self.stats["repetition"] += 1
            return True, "repetition"

        for i, (ts, h) in enumerate(reversed(self.history)):
            if t.lower() == h.lower():
                self.stats["skipped"] += 1
                self.stats["exact_duplicate"] += 1
                return True, "exact_duplicate"
            if self._is_extension(t, h):
                # replace the old entry and let the extension through
                idx = len(self.history) - 1 - i
                self.history[idx] = (now, t)
                self.stats["extended"] += 1
                return False, "extension"
            if self._is_partial_match(t, h):
                self.stats["skipped"] += 1
                self.stats["partial_match"] += 1
                return True, "partial_match"
            quick = SequenceMatcher(None, t.lower(), h.lower()).ratio()
            if quick >= self.similarity_threshold or (
                quick >= self.similarity_threshold * 0.8
                and levenshtein_ratio(t.lower(), h.lower()) >= self.similarity_threshold
            ):
                self.stats["skipped"] += 1
                self.stats["similar"] += 1
                return True, "similar"

        self.history.append((now, t))
        return False, "new"

    # ---------------------------------------------------------------- service

    def get_stats(self) -> dict:
        out = dict(self.stats)
        out["skip_rate"] = out["skipped"] / out["total"] if out["total"] else 0.0
        return out

    def reset(self):
        self.history.clear()
        for k in self.stats:
            self.stats[k] = 0
