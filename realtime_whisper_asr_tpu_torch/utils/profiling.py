"""Profiling hooks: torch.profiler traces and a simple phase timer.

Port of ``realtime_whisper_asr_tpu/utils/profiling.py``: wrap any code in
``trace(dir)`` for a ``torch.profiler`` trace (CPU and, with a card, CUDA
activity; open it in Perfetto or TensorBoard), or use ``PhaseTimer`` for
cheap wall-clock phase accounting of the ASR's ticks
(``TorchWhisperASR.phase_timer``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from realtime_whisper_asr_tpu_torch.device import resolve_device


def sync_device(device: torch.device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, its trace written into ``log_dir``
    (created if missing) when the block ends. Yields the profiler, whose
    ``key_averages()`` sums time by operation and kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def measure_sync_floor(n: int = 12, device="cuda") -> float:
    """Median ms of a minimal device round trip: one tiny kernel, then
    ``torch.cuda.synchronize``. Phase breakdowns that synchronize at phase
    boundaries (``TorchWhisperASR.phase_timer``) overstate every phase by
    this floor. Raises on a host without CUDA."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_sync_floor measures a CUDA device, not {device}")
    x = torch.zeros(8, device=device)
    x.add_(1.0)  # first launch outside the measurement
    torch.cuda.synchronize(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        x.add_(1.0)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e3 * times[len(times) // 2]


class PhaseTimer:
    """Accumulates wall time per named phase; negligible overhead."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self.clock()
        try:
            yield
        finally:
            self.totals[name] += self.clock() - t0
            self.counts[name] += 1

    # lap-style API for instrumenting straight-line pipelines (asr.py hot path)
    def mark(self) -> None:
        self._t = self.clock()

    def lap(self, name: str) -> None:
        now = self.clock()
        self.totals[name] += now - getattr(self, "_t", now)
        self.counts[name] += 1
        self._t = now

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in sorted(self.totals)
        }
