"""Structured session logging: CSV + text log (reference log_manager.py:16-163).

Writes ``logs/session_<ts>.csv`` with the reference's 13-column schema and a
parallel ``session_<ts>.log``; console handler policy is config-driven. The
reference defines this but never constructs it in main() — here the app loop
wires it in when ``logging.enable`` is set.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Optional

CSV_HEADER = [
    "timestamp", "session_time_s", "event", "begin_s", "end_s", "text",
    "translation", "language", "model", "latency_ms", "rtf", "skipped_reason", "extra",
]


class LogManager:
    #: per-process uniquifier: two sessions constructed within the same
    #: second would otherwise share one logger name (both FileHandlers got
    #: every record) and one CSV path (the second open('w') truncated the
    #: first session's file mid-write)
    _seq = 0

    def __init__(self, log_dir: str = "logs", console: bool = False,
                 session_name: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        if session_name is None:
            LogManager._seq += 1
            ts = f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}_{LogManager._seq}"
        else:
            ts = session_name
        self.csv_path = os.path.join(log_dir, f"session_{ts}.csv")
        self.log_path = os.path.join(log_dir, f"session_{ts}.log")
        self._csv_file = open(self.csv_path, "w", newline="", encoding="utf-8")
        self._csv = csv.writer(self._csv_file)
        self._csv.writerow(CSV_HEADER)
        self._t0 = time.time()

        self.logger = logging.getLogger(f"rtwa.session.{ts}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.handlers.clear()  # explicit name reuse must not double-log
        fh = logging.FileHandler(self.log_path, encoding="utf-8")
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        self.logger.addHandler(fh)
        if console:
            ch = logging.StreamHandler()
            ch.setFormatter(logging.Formatter("%(message)s"))
            self.logger.addHandler(ch)

    def _row(self, event: str, **kw):
        self._csv.writerow([
            time.strftime("%Y-%m-%d %H:%M:%S"),
            f"{time.time() - self._t0:.2f}",
            event,
            kw.get("begin", ""), kw.get("end", ""), kw.get("text", ""),
            kw.get("translation", ""), kw.get("language", ""), kw.get("model", ""),
            kw.get("latency_ms", ""), kw.get("rtf", ""), kw.get("skipped_reason", ""),
            kw.get("extra", ""),
        ])
        self._csv_file.flush()

    # ----------------------------------------------------------------- events

    def log_recognition(self, begin: float, end: float, text: str,
                        latency_ms: float | None = None, language: str = "",
                        model: str = ""):
        self._row("recognition", begin=begin, end=end, text=text,
                  latency_ms=latency_ms, language=language, model=model)
        self.logger.info("recognition [%.2f-%.2f] %s", begin, end, text)

    def log_skip(self, text: str, reason: str):
        self._row("skip", text=text, skipped_reason=reason)
        self.logger.info("skip (%s): %s", reason, text)

    def log_translation(self, source: str, translation: str):
        self._row("translation", text=source, translation=translation)
        self.logger.info("translation: %s -> %s", source, translation)

    def log_optimization(self, description: str):
        self._row("optimization", extra=description)
        self.logger.info("optimization: %s", description)

    def log_performance(self, rtf: float | None, latency_ms: float | None,
                        extra: str = ""):
        self._row("performance", rtf=rtf, latency_ms=latency_ms, extra=extra)

    def log_error(self, message: str):
        self._row("error", extra=message)
        self.logger.error("%s", message)

    def log_config(self, config: dict):
        self._row("config", extra=repr(config))

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
        self._csv_file.close()
