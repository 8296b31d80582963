"""Speech-rate detection → adaptive VAD silence duration.

Capability parity with `speech_rate_adaptive.py` (SpeechRateDetector
:14-106, AdaptiveSilenceController :109-210, SpeechRateAdaptiveProcessor
:213-273) plus the simpler inline variant the reference main loop actually
runs (`一键实时识别麦克风.py:1614-1644`: average result gap → 200–1000 ms),
exposed here as ``gap_based_silence_ms``.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Callable, Optional


class SpeechRateDetector:
    """chars/sec over a sliding window of recognition results.

    The window is count-bounded (last ``window`` results) AND time-bounded
    (``max_age_s``): after a long pause, stale samples expire instead of
    classifying the resumed speech from minutes-old results."""

    def __init__(self, window: int = 5, slow_cps: float = 5.0, fast_cps: float = 15.0,
                 clock: Callable[[], float] = _time.time, max_age_s: float = 30.0):
        self.samples: deque[tuple[float, float, int]] = deque(maxlen=window)
        self.slow_cps = slow_cps
        self.fast_cps = fast_cps
        self.clock = clock
        self.max_age_s = max_age_s

    def add_result(self, text: str, duration_s: float, current_time: Optional[float] = None):
        now = self.clock() if current_time is None else current_time
        # expire relative to the INCOMING sample's time (one timebase —
        # callers may feed a session clock): the first result after a long
        # pause evicts the stale window right where the classification is
        # about to be used
        while self.samples and now - self.samples[0][0] > self.max_age_s:
            self.samples.popleft()
        if duration_s > 0:
            self.samples.append((now, duration_s, len(text.strip())))

    def chars_per_second(self, current_time: Optional[float] = None) -> Optional[float]:
        # expire on READ as well: the stretch/adaptive-params path consults
        # this every chunk, and after a long pause no add_result has fired
        # yet to evict the stale window — the resumed speech would be
        # stretched at the minutes-old rate until the first new result
        now = self.clock() if current_time is None else current_time
        while self.samples and now - self.samples[0][0] > self.max_age_s:
            self.samples.popleft()
        if not self.samples:
            return None
        total_t = sum(d for _, d, _ in self.samples)
        total_c = sum(c for _, _, c in self.samples)
        return total_c / total_t if total_t > 0 else None

    def classify(self, current_time: Optional[float] = None) -> str:
        cps = self.chars_per_second(current_time)
        if cps is None:
            return "unknown"
        if cps < self.slow_cps:
            return "slow"
        if cps > self.fast_cps:
            return "fast"
        return "normal"


class AdaptiveSilenceController:
    """Steps min-silence toward min/max by rate class; decays to initial."""

    def __init__(self, initial_ms: float = 500.0, min_ms: float = 200.0, max_ms: float = 1000.0,
                 step_ms: float = 100.0):
        self.initial_ms = initial_ms
        self.current_ms = initial_ms
        self.min_ms = min_ms
        self.max_ms = max_ms
        self.step_ms = step_ms

    def update(self, rate_class: str) -> float:
        if rate_class == "fast":
            self.current_ms = max(self.min_ms, self.current_ms - self.step_ms)
        elif rate_class == "slow":
            self.current_ms = min(self.max_ms, self.current_ms + self.step_ms)
        else:  # decay toward initial
            if self.current_ms > self.initial_ms:
                self.current_ms = max(self.initial_ms, self.current_ms - self.step_ms / 2)
            elif self.current_ms < self.initial_ms:
                self.current_ms = min(self.initial_ms, self.current_ms + self.step_ms / 2)
        return self.current_ms


def gap_based_silence_ms(avg_gap_s: float) -> float:
    """The main-loop heuristic (reference 一键…py:1614-1644): average gap
    between results → silence duration. <2 s → 200-300; 2-5 s → 300-600;
    >5 s → 600-1000 (linear within bands)."""
    if avg_gap_s < 2.0:
        return 200.0 + 50.0 * avg_gap_s
    if avg_gap_s <= 5.0:
        return 300.0 + 100.0 * (avg_gap_s - 2.0)
    return min(1000.0, 600.0 + 80.0 * (avg_gap_s - 5.0))


class SpeechRateAdaptiveProcessor:
    """Binds detector + controller to a VAC processor's set_silence_duration."""

    def __init__(self, vad_processor, update_interval_s: float = 2.0,
                 slow_cps: float = 5.0, fast_cps: float = 15.0,
                 clock: Callable[[], float] = _time.time, **controller_kw):
        self.vad_processor = vad_processor
        self.detector = SpeechRateDetector(slow_cps=slow_cps, fast_cps=fast_cps, clock=clock)
        self.controller = AdaptiveSilenceController(**controller_kw)
        self.update_interval_s = update_interval_s
        self.clock = clock
        self._last_update = 0.0

    def on_result(self, text: str, beg: float, end: float,
                  current_time: Optional[float] = None) -> Optional[float]:
        """Feed a recognition result; returns the new silence ms if applied."""
        now = self.clock() if current_time is None else current_time
        self.detector.add_result(text, max(end - beg, 1e-3), now)
        if now - self._last_update < self.update_interval_s:
            return None
        self._last_update = now
        ms = self.controller.update(self.detector.classify())
        if hasattr(self.vad_processor, "set_silence_duration"):
            if self.vad_processor.set_silence_duration(ms):
                return ms
        return None
