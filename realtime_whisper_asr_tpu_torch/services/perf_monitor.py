"""Performance monitoring + load-shedding predicates.

Parity with the reference PerformanceMonitor (`performance_monitor.py:13-413`)
— which is defined there but never wired into main(); here it is first-class
(bench.py and the app loop both use it):

- recognition speed ratio = audio-seconds / processing-seconds (inverse RTF,
  :147-175) over a sliding window, plus latency percentiles
- API call window stats (:84-105)
- backpressure predicates: should_skip_recognition (queue ≥3, ratio <0.4 hard
  / <0.6 soft, processing >2.5× audio, :177-251), should_skip_translation
  (:253-302), should_skip_optimization (:304-350)
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import numpy as np


class PerformanceMonitor:
    def __init__(
        self,
        window: int = 20,
        hard_ratio: float = 0.4,
        soft_ratio: float = 0.6,
        max_proc_over_audio: float = 2.5,
        max_queue: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window = window
        self.hard_ratio = hard_ratio
        self.soft_ratio = soft_ratio
        self.max_proc_over_audio = max_proc_over_audio
        self.max_queue = max_queue
        self.clock = clock
        self.recognitions: deque[tuple[float, float]] = deque(maxlen=window)  # (audio_s, proc_s)
        self.latencies: deque[float] = deque(maxlen=10 * window)
        self.api_calls: deque[tuple[float, bool, float]] = deque(maxlen=window)  # (t, ok, dur)
        self.queue_depth = 0
        # bounded like every other monitor buffer: an overloaded server sheds
        # per ready stream per round, and an unbounded log leaks for days
        self.skip_log: deque[tuple[float, str]] = deque(maxlen=1000)
        self.skips_total = 0

    # --------------------------------------------------------------- recording

    def record_recognition(self, audio_seconds: float, processing_seconds: float):
        self.recognitions.append((audio_seconds, processing_seconds))
        self.latencies.append(processing_seconds)

    def record_api_call(self, ok: bool, duration_s: float):
        self.api_calls.append((self.clock(), ok, duration_s))

    def set_queue_depth(self, depth: int):
        self.queue_depth = depth

    # ----------------------------------------------------------------- metrics

    def get_recognition_speed_ratio(self) -> Optional[float]:
        """audio-sec / proc-sec; >1 means faster than realtime (inverse RTF)."""
        if not self.recognitions:
            return None
        audio = sum(a for a, _ in self.recognitions)
        proc = sum(p for _, p in self.recognitions)
        return audio / proc if proc > 0 else None

    def rtf(self) -> Optional[float]:
        r = self.get_recognition_speed_ratio()
        return (1.0 / r) if r else None

    def latency_percentiles(self) -> dict:
        if not self.latencies:
            return {}
        arr = np.asarray(self.latencies)
        return {
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }

    def api_success_rate(self) -> Optional[float]:
        if not self.api_calls:
            return None
        return sum(1 for _, ok, _ in self.api_calls if ok) / len(self.api_calls)

    # ------------------------------------------------------------ backpressure

    def _log_skip(self, kind: str):
        self.skip_log.append((self.clock(), kind))
        self.skips_total += 1

    def should_skip_recognition(self, audio_seconds: float = 0.0) -> tuple[bool, str]:
        """Shed decision for a tick covering ``audio_seconds`` of pending
        audio. The proc>2.5x check gates on THAT duration when given (a long
        recent tick sheds a small pending chunk), falling back to the last
        recognition's own audio span (reference history-only semantics,
        `performance_monitor.py:236-249`)."""
        if self.queue_depth >= self.max_queue:
            self._log_skip("recognition:queue")
            return True, f"queue_depth={self.queue_depth}"
        ratio = self.get_recognition_speed_ratio()
        if ratio is not None and ratio < self.hard_ratio:
            self._log_skip("recognition:hard_ratio")
            return True, f"speed_ratio={ratio:.2f}<hard {self.hard_ratio}"
        if self.recognitions:
            last_audio, last_proc = self.recognitions[-1]
            base = audio_seconds if audio_seconds > 0 else last_audio
            if base > 0 and last_proc > self.max_proc_over_audio * base:
                self._log_skip("recognition:proc_over_audio")
                return True, (f"last proc {last_proc:.2f}s > "
                              f"{self.max_proc_over_audio}x {base:.2f}s audio")
        return False, "ok"

    def should_skip_translation(self) -> tuple[bool, str]:
        ratio = self.get_recognition_speed_ratio()
        if ratio is not None and ratio < self.hard_ratio:
            self._log_skip("translation:ratio")
            return True, f"speed_ratio={ratio:.2f}"
        ok_rate = self.api_success_rate()
        if ok_rate is not None and ok_rate < 0.3:
            self._log_skip("translation:api")
            return True, f"api_success={ok_rate:.2f}"
        return False, "ok"

    def should_skip_optimization(self) -> tuple[bool, str]:
        ratio = self.get_recognition_speed_ratio()
        if ratio is not None and ratio < self.soft_ratio:
            self._log_skip("optimization:ratio")
            return True, f"speed_ratio={ratio:.2f}<soft {self.soft_ratio}"
        return False, "ok"

    # ------------------------------------------------------------------ status

    def get_status(self) -> dict:
        out = {
            "speed_ratio": self.get_recognition_speed_ratio(),
            "rtf": self.rtf(),
            "queue_depth": self.queue_depth,
            "api_success_rate": self.api_success_rate(),
            "n_recognitions": len(self.recognitions),
            "skips": self.skips_total,
        }
        out.update(self.latency_percentiles())
        return out
