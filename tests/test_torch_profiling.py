"""The port's profiling hooks (``utils/profiling.py``) and the ASR's phase laps.

``PhaseTimer`` is held against a fake clock; a ``TorchWhisperASR`` on the CPU
with a timer set reports the reference's five laps once per window.
"""

import glob
import os

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.utils import profiling

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


class FakeClock:
    def __init__(self, *times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def test_phase_accumulates_time_and_count():
    timer = profiling.PhaseTimer(clock=FakeClock(1.0, 1.5, 2.0, 2.25))
    with timer.phase("encode"):
        pass
    with pytest.raises(KeyError), timer.phase("encode"):
        raise KeyError("the phase still counts")
    assert timer.totals["encode"] == pytest.approx(0.75)
    assert timer.counts["encode"] == 2
    assert timer.report() == {"encode": {"total_s": 0.75, "count": 2, "mean_ms": 375.0}}


def test_lap_measures_from_the_last_mark_or_lap():
    timer = profiling.PhaseTimer(clock=FakeClock(10.0, 10.2, 10.5, 11.0, 20.0))
    timer.mark()
    timer.lap("upload")
    timer.lap("encode")
    timer.lap("upload")
    assert timer.totals["upload"] == pytest.approx(0.2 + 0.5)
    assert timer.counts["upload"] == 2
    assert timer.totals["encode"] == pytest.approx(0.3)
    fresh = profiling.PhaseTimer(clock=FakeClock(20.0))
    fresh.lap("decode")  # no mark yet: a zero lap
    assert fresh.totals["decode"] == 0.0 and fresh.counts["decode"] == 1


def test_transcribe_laps_the_five_phases():
    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 8
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(2 * 16000)).astype(np.float32)
    asr.transcribe(audio)  # no timer: nothing is lapped
    asr.phase_timer = profiling.PhaseTimer()
    asr.transcribe(audio)
    asr.transcribe(audio)
    report = asr.phase_timer.report()
    assert set(report) == {"upload", "encode", "decode", "download", "host_parse"}
    assert all(row["count"] == 2 and row["total_s"] >= 0 for row in report.values())


def test_trace_writes_a_profiler_trace(tmp_path):
    log_dir = os.path.join(tmp_path, "trace")
    with profiling.trace(log_dir) as prof:
        torch.ones(64).cumsum(0)
    assert prof.key_averages()
    assert glob.glob(os.path.join(log_dir, "*.json"))


def test_sync_floor_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.measure_sync_floor()
    with pytest.raises(ValueError, match="CUDA device"):
        profiling.measure_sync_floor(device="cpu")
