"""Fixtures of the benchmark's own tests: a copy of the benchmark at
test-tiny, in a temporary root, that the harness runs on the CPU.

The tests that need a card carry the ``chip`` marker and decide inside the
test whether to skip.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: test-tiny's sizes in the benchmark's configuration keys
TINY = {"name": "tiny.int8-all", "model": "test-tiny", "dtype": "float32", "d_model": 64,
        "encoder_layers": 2, "decoder_layers": 2, "encoder_attention_heads": 2,
        "decoder_attention_heads": 2, "encoder_ffn_dim": 256, "decoder_ffn_dim": 256,
        "num_mel_bins": 80, "vocab_size": 51865, "max_source_positions": 1500,
        "max_target_positions": 448}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def tiny_config(**over) -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "large-v3.int8-all.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["limits"] = {"widest_gap": 0.05, "min_positions": 20}
    cfg.update(over)
    return cfg


def make_root(tmp, dtype: str = "float32") -> tuple[str, str]:
    """A root holding a copy of the benchmark with one cell ``tiny.cell`` of
    test-tiny under a shortened ``one_stream`` mix. -> (root, BENCHMARK.json)."""
    root = str(tmp)
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    with open(os.path.join(root, "portbench", "configs", "tiny.int8-all.json"), "w") as f:
        json.dump(tiny_config(dtype=dtype), f)
    with open(os.path.join(REPO, "portbench", "traffic", "one_stream.json")) as f:
        t = json.load(f)
    t["audio_s"] = 300.0
    with open(os.path.join(root, "portbench", "traffic", "tiny_mix.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny.int8-all", "source": "https://example.org/test-tiny",
                         "file": "portbench/configs/tiny.int8-all.json", "reduced": [],
                         "why": "test-tiny"}]
    bench["workloads"] = [{"name": "tiny.cell", "config": "tiny.int8-all",
                           "traffic": "tiny_mix", "chips": 1, "why": "test-tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root, path


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
