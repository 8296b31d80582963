"""Audio-device failure protection: probe, retry-open, health, auto-recover.

Capability parity with the reference AudioDeviceProtector
(`audio_device_protector.py:14-311`): availability probe with a validation
read (:34-73, :118-129), open with up to ``max_retries`` attempts and delay
(:75-166), health check (:168-190), close-reopen recovery with a counter
(:192-235), and ``read_audio`` that auto-recovers on device errors (:237-277).

The stream source is an injectable factory (``() -> stream``) so fault
scenarios (device occupied, unplug-recover) are unit-testable — the manual
test matrix the reference documents in 改进说明.md §3.5 runs here as code.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)


class AudioDeviceProtector:
    def __init__(
        self,
        stream_factory: Callable[[], object],
        max_retries: int = 3,
        retry_delay_s: float = 1.0,
        recover_delay_s: float = 0.5,
        validation_read: int = 256,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.stream_factory = stream_factory
        self.max_retries = max_retries
        self.retry_delay_s = retry_delay_s
        self.recover_delay_s = recover_delay_s
        self.validation_read = validation_read
        self.sleep = sleep
        self.stream = None
        self.recoveries = 0
        self.failed_reads = 0
        self.healthy = False

    # ------------------------------------------------------------------ open

    def check_device_available(self) -> bool:
        try:
            s = self.stream_factory()
            try:
                s.read(self.validation_read)
            finally:
                s.close()
            return True
        except Exception as e:
            logger.warning("device probe failed: %s", e)
            return False

    def open_stream(self):
        last_err: Optional[Exception] = None
        for attempt in range(1, self.max_retries + 1):
            try:
                s = self.stream_factory()
                data, _ = s.read(self.validation_read)  # validation read
                if len(data) != self.validation_read:
                    raise OSError("validation read returned short buffer")
                self.stream = s
                self.healthy = True
                logger.info("stream opened on attempt %d", attempt)
                return s
            except Exception as e:
                last_err = e
                logger.warning("open attempt %d/%d failed: %s", attempt, self.max_retries, e)
                if attempt < self.max_retries:  # no pointless sleep before the raise
                    self.sleep(self.retry_delay_s)
        self.healthy = False
        raise RuntimeError(f"could not open audio stream after {self.max_retries} tries: {last_err}")

    # ---------------------------------------------------------------- recover

    def check_stream_health(self) -> bool:
        if self.stream is None:
            return False
        closed = getattr(self.stream, "closed", False)
        self.healthy = not closed
        return self.healthy

    def recover_stream(self):
        logger.warning("recovering audio stream")
        if self.stream is not None:
            try:
                self.stream.close()
            except Exception:
                pass
            self.stream = None
        self.sleep(self.recover_delay_s)
        s = self.open_stream()
        self.recoveries += 1
        return s

    # ------------------------------------------------------------------ read

    def read_audio(self, n: int) -> tuple[np.ndarray, bool]:
        """Read n samples; on device error, recover once and retry the read.

        Returns (audio, recovered_flag). Raises only if recovery also fails.
        """
        if self.stream is None:
            self.open_stream()
        try:
            data, _ = self.stream.read(n)
            return data, False
        except Exception as e:
            self.failed_reads += 1
            logger.warning("read failed (%s); attempting recovery", e)
            self.recover_stream()
            data, _ = self.stream.read(n)
            return data, True

    def close(self):
        if self.stream is not None:
            try:
                self.stream.close()
            finally:
                self.stream = None
                self.healthy = False

    def get_status(self) -> dict:
        return {
            "healthy": self.healthy,
            "recoveries": self.recoveries,
            "failed_reads": self.failed_reads,
            "open": self.stream is not None,
        }
