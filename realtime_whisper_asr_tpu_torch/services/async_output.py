"""Non-blocking console output: a bounded queue drained by a daemon thread.

Parity with the reference AsyncOutput (`一键实时识别麦克风.py:432-509`):
maxsize-100 queue, overflow falls back to synchronous print, flush joins the
queue, stop() with join timeout.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Callable, Optional


class AsyncOutput:
    def __init__(self, maxsize: int = 100, write: Optional[Callable[[str], None]] = None):
        self.queue: queue.Queue[Optional[str]] = queue.Queue(maxsize=maxsize)
        self.write = write or (lambda s: (sys.stdout.write(s + "\n"), sys.stdout.flush()))
        self.dropped_to_sync = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True, name="rtwa-output")
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                self.queue.task_done()
                break
            try:
                self.write(item)
            finally:
                self.queue.task_done()

    def print(self, text: str):
        try:
            self.queue.put_nowait(text)
        except queue.Full:
            # overflow: degrade to synchronous output (reference :488-499)
            self.dropped_to_sync += 1
            self.write(text)

    def flush(self, timeout: float = 2.0):
        deadline = threading.Event()
        t = threading.Timer(timeout, deadline.set)
        t.start()
        try:
            while not self.queue.empty() and not deadline.is_set():
                threading.Event().wait(0.01)
        finally:
            t.cancel()

    def stop(self, timeout: float = 2.0):
        self.flush(timeout)
        self._stop.set()
        try:
            self.queue.put_nowait(None)
        except queue.Full:
            pass
        self.thread.join(timeout)
