"""The port's soak (CPU, test-tiny).

- ``run_soak(0.5, device="cpu")`` is ok and reports the JAX tool's keys,
  with ``graph_keys`` / ``recaptures`` in place of ``jit_signatures``.
- Each check can fail: one leak at a time, monkeypatched in, gives its
  failure. The leak runs use a 1-token-a-second transcript cap and, but for
  the skip detector's, no VAD (every tick decodes), so a quarter of a
  simulated minute shows each.
"""

import itertools

import pytest
import torch

from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.pipeline.skip_detector import SkipDetector
from realtime_whisper_asr_tpu_torch.streaming.online import OnlineASRProcessor
from realtime_whisper_asr_tpu_torch.tools import soak as PT

torch.set_num_threads(2)

REPORT_KEYS = {"simulated_minutes", "ticks", "wall_seconds", "soak_rtf", "tick_ms_early",
               "tick_ms_late", "audio_buffer_s_max", "commited_words", "results",
               "rss_mb_end", "rss_mb_growth_after_warmup", "graph_keys", "recaptures",
               "failures", "ok"}
LEAN = {"model.max_tokens_per_second": 1.0, "vad.enable": False}


def test_soak_is_ok_and_reports_the_reference_keys():
    report = PT.run_soak(0.5, device="cpu")
    assert report["ok"], report["failures"]
    assert set(report) == REPORT_KEYS
    assert report["ticks"] == 30 and report["graph_keys"] >= 1 and report["recaptures"] >= 0


class _StuckStream:
    def query(self):
        return False


def _leak(kind: str, monkeypatch) -> tuple[float, dict]:
    """Monkeypatch one leak in -> (minutes, extra config) of its run."""
    if kind == "audio_buffer":  # the buffer is never cut
        monkeypatch.setattr(OnlineASRProcessor, "chunk_at", lambda self, time: None)
        return 0.7, {**LEAN, "streaming.buffer_trimming_sec": 1.0,
                     "audio_deduplication.enable": False}
    if kind == "skip_history":  # the skip detector keeps what it prunes, and more
        should_skip = SkipDetector.should_skip

        def leaky(self, text, current_time=None):
            out = should_skip(self, text, current_time)
            self.history.extend([(current_time, text)] * 1001)
            return out

        monkeypatch.setattr(SkipDetector, "should_skip", leaky)
        return 0.5, {"model.max_tokens_per_second": 1.0}
    if kind == "unfinalised":  # a pipelined session never finalises its last window
        return 0.25, {**LEAN, "streaming.pipeline": True}
    if kind == "copy_stream":  # a result copy that never completes
        init = D.DecodeLoop.__init__

        def stuck(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self._copy_stream = _StuckStream()

        monkeypatch.setattr(D.DecodeLoop, "__init__", stuck)
        return 0.25, LEAN
    # a new loop shape every window
    counter, key = itertools.count(1), D.LoopKey
    monkeypatch.setattr(D, "LoopKey", lambda model_id, *rest: key(model_id + next(counter),
                                                                  *rest))
    return 0.25, LEAN


@pytest.mark.parametrize("kind,failure", [
    ("audio_buffer", "audio_buffer"),
    ("skip_history", "skip history unbounded"),
    ("unfinalised", "left unfinalised"),
    ("copy_stream", "copy stream"),
    ("loop_keys", "loop keys grew"),
])
def test_each_check_can_fail(kind, failure, monkeypatch):
    minutes, config = _leak(kind, monkeypatch)
    report = PT.run_soak(minutes, device="cpu", config=config)
    assert not report["ok"]
    assert [f for f in report["failures"] if failure in f], report["failures"]
