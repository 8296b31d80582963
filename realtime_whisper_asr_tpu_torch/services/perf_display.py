"""Colored TTY status output (reference performance_display.py:14-242).

Throttled status line with runtime/skip/dedup/device-health counters plus
display_error/warning/success/info/progress helpers. Color is disabled
automatically when stdout is not a TTY.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

COLORS = {
    "red": "\033[91m",
    "green": "\033[92m",
    "yellow": "\033[93m",
    "blue": "\033[94m",
    "magenta": "\033[95m",
    "cyan": "\033[96m",
    "white": "\033[97m",
    "reset": "\033[0m",
    "bold": "\033[1m",
}


class PerformanceDisplay:
    def __init__(
        self,
        interval_s: float = 5.0,
        color: Optional[bool] = None,
        write: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.interval_s = interval_s
        self.write = write or (lambda s: print(s, flush=True))
        self.clock = clock
        self.color_enabled = color if color is not None else sys.stdout.isatty()
        self.start_time = self.clock()
        self._last_stats = 0.0

    def colorize(self, text: str, color: str) -> str:
        if not self.color_enabled or color not in COLORS:
            return text
        return f"{COLORS[color]}{text}{COLORS['reset']}"

    @staticmethod
    def format_duration(seconds: float) -> str:
        seconds = int(seconds)
        h, rem = divmod(seconds, 3600)
        m, s = divmod(rem, 60)
        return f"{h:02d}:{m:02d}:{s:02d}" if h else f"{m:02d}:{s:02d}"

    # ------------------------------------------------------------------ status

    def display_stats(self, monitor=None, skip_stats: dict | None = None,
                      dedup_stats: dict | None = None, device_status: dict | None = None,
                      force: bool = False):
        """Throttled one-line status (reference :81-158)."""
        now = self.clock()
        if not force and now - self._last_stats < self.interval_s:
            return
        self._last_stats = now
        parts = [f"📊 {self.format_duration(now - self.start_time)}"]
        if monitor is not None:
            st = monitor.get_status()
            if st.get("rtf") is not None:
                parts.append(f"RTF {st['rtf']:.3f}")
            if st.get("p50_ms") is not None:
                parts.append(f"p50 {st['p50_ms']:.0f}ms")
        if skip_stats:
            parts.append(f"skips {skip_stats.get('skipped', 0)}/{skip_stats.get('total', 0)}")
        if dedup_stats:
            parts.append(f"dedup {dedup_stats.get('skipped', 0)}/{dedup_stats.get('total', 0)}")
        if device_status:
            health = "ok" if device_status.get("healthy", True) else "RECOVERING"
            parts.append(f"dev {health} (rec {device_status.get('recoveries', 0)})")
        self.write(self.colorize(" | ".join(parts), "cyan"))

    # ----------------------------------------------------------------- helpers

    def display_error(self, msg: str):
        self.write(self.colorize(f"❌ {msg}", "red"))

    def display_warning(self, msg: str):
        self.write(self.colorize(f"⚠️  {msg}", "yellow"))

    def display_success(self, msg: str):
        self.write(self.colorize(f"✅ {msg}", "green"))

    def display_info(self, msg: str):
        self.write(self.colorize(f"ℹ️  {msg}", "blue"))

    def display_progress(self, msg: str):
        self.write(self.colorize(f"⏳ {msg}", "magenta"))
