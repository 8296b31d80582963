"""The port's ``torch.profiler`` hook (``utils/profiling.trace``); the spans
are held in ``tests/test_torch_spans.py``."""

import glob
import os

import torch

from realtime_whisper_asr_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_trace_writes_a_profiler_trace(tmp_path):
    log_dir = os.path.join(tmp_path, "trace")
    with profiling.trace(log_dir) as prof:
        torch.ones(64).cumsum(0)
    assert prof.key_averages()
    assert glob.glob(os.path.join(log_dir, "*.json"))
