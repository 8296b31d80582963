"""The port's calibration tool against the JAX package's (CPU).

- ``write_synthetic_dir(root, seed=3)`` writes the JAX tool's files, byte
  for byte.
- ``calibrate_dir`` on that directory gives the JAX tool's JSON: the
  thresholds equal, every other number equal (the VAD's probabilities are
  the port's torch net against the JAX net, within ~1e-6, so a threshold
  could differ only at a near tie of the balanced accuracy or the EER,
  which the test would name).
- ``main([dir, "--synth", "--write-config", ...])`` passes the JAX test's
  assertions (``tests/test_calibrate_drill.py``), and a directory with only
  ``speakers.jsonl`` calibrates only the speaker threshold.
"""

import json
import os
import sys

import torch

from realtime_whisper_asr_tpu_torch.tools import calibrate as PT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import calibrate

    return calibrate


def _files(root: str) -> dict:
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def test_synthetic_dir_and_calibration_equal_jax_tool(tmp_path):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    PT.write_synthetic_dir(ours, seed=3)
    _jax_tool().write_synthetic_dir(theirs, seed=3)
    a, b = _files(ours), _files(theirs)
    assert sorted(a) == sorted(b) and len(a) == 3 + 12 + 18 + 24
    assert all(a[k] == b[k] for k in b), [k for k in b if a[k] != b[k]]
    cal = PT.calibrate_dir(ours, device="cpu")
    ref = _jax_tool().calibrate_dir(theirs)
    assert cal == ref, (cal, ref)


def test_calibrate_full_chain_on_synthetic_dir(tmp_path):
    """``tests/test_calibrate_drill.py``'s chain and assertions, through
    the port's ``main`` with ``--cpu``."""
    root = str(tmp_path / "corpus")
    cfg_path = str(tmp_path / "config.json")
    rc = PT.main([root, "--synth", "--out", str(tmp_path / "cal.json"),
                  "--write-config", cfg_path, "--seed", "3", "--cpu"])
    assert rc == 0
    cal = json.load(open(tmp_path / "cal.json"))
    assert set(cal) == {"vad", "speaker", "dedup"}
    assert 0.05 <= cal["vad"]["threshold"] <= 0.95
    assert cal["vad"]["auc"] > 0.9
    assert -1.0 <= cal["speaker"]["threshold"] <= 1.0
    assert cal["speaker"]["eer"] < 0.25
    assert 0.0 <= cal["dedup"]["similarity_threshold"] <= 1.0
    assert cal["dedup"]["similarity_threshold"] <= cal["dedup"]["duplicate_threshold"]
    cfg = json.load(open(cfg_path))
    assert cfg["vad"]["threshold"] == cal["vad"]["threshold"]
    assert cfg["diarization"]["threshold"] == cal["speaker"]["threshold"]
    assert (cfg["audio_deduplication"]["similarity_threshold"]
            == cal["dedup"]["similarity_threshold"])
    assert (cfg["audio_deduplication"]["duplicate_threshold"]
            == cal["dedup"]["duplicate_threshold"])


def test_calibrate_partial_dir_only_present_manifests(tmp_path):
    root = str(tmp_path / "corpus")
    PT.write_synthetic_dir(root, seed=0, n_clips=4, n_speakers=3, utts=2)
    os.remove(os.path.join(root, "vad.jsonl"))
    os.remove(os.path.join(root, "dedup.jsonl"))
    assert set(PT.calibrate_dir(root, device="cpu")) == {"speaker"}
