"""The port's checkpoint drill on an HF directory (CPU).

The directory is written by ``transformers`` as ``tests/test_torch_load.py``
writes its ``hf_dir`` (d_model 64, 2 + 2 layers), with a byte-level
``vocab.json`` / ``merges.txt`` and alignment heads beside it. The port's
drill reports the JAX drill's steps, each ok: the HF and the converted
directories decode the same tokens greedy and at beam 5, the ``int8-all``
artifact is detected as such and decodes as quantizing at load does, the
sidecars survive the conversion, a streaming session runs, and a manifest
adds the ``wer`` step. The JAX drill on the same directory reports the same
steps with the same ``ok`` flags.

Both drills' ASRs decode at most 32 tokens a window here (random weights
never emit EOT, and a CPU beam search of the full 224 takes a minute): every
step compares the same capped decodes on both sides.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.io import write_wav
from realtime_whisper_asr_tpu_torch.tools import checkpoint_drill as PT

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ["convert", "reload", "decode_parity", "prequant_artifact", "beam5", "stream"]


def _capped(cls, monkeypatch):
    init = cls.__init__

    def capped_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.transcribe_kargs.update(max_new_tokens=32, max_total_tokens=32)

    monkeypatch.setattr(cls, "__init__", capped_init)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """(the HF directory, the port drill's report, its standard output)."""
    from tests.test_tokenizer import byte_vocab_with_merges
    from tests.test_torch_load import hf_dir

    tmp = tmp_path_factory.mktemp("drill")
    path = hf_dir(tmp, alignment_heads=[[1, 0], [1, 1]])
    vocab, merges = byte_vocab_with_merges()
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    wav = str(tmp / "a.wav")
    write_wav(wav, (0.1 * np.random.default_rng(1).standard_normal(16000)).astype(np.float32))
    manifest = str(tmp / "m.jsonl")
    with open(manifest, "w") as f:
        f.write(json.dumps({"wav": wav, "text": "hello"}) + "\n")
    report_path = str(tmp / "drill.json")
    with pytest.MonkeyPatch.context() as mp:
        _capped(TorchWhisperASR, mp)
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = PT.main([path, "--work", str(tmp / "work"), "--report", report_path,
                          "--manifest", manifest, "--cpu"])
    assert rc == 0, buf.getvalue()[-2000:]
    with open(report_path) as f:
        return path, json.load(f), buf.getvalue()


def test_drill_reports_every_step_ok(drill):
    _, rep, out = drill
    assert rep["ok"], rep
    assert list(rep["steps"]) == STEPS + ["wer"]
    assert all(s["ok"] for s in rep["steps"].values())
    assert rep["steps"]["prequant_artifact"]["detected"] == "int8-all"
    assert rep["steps"]["reload"]["real_tokenizer"] and rep["steps"]["reload"]["alignment_heads"]
    assert rep["steps"]["wer"]["clips"] == 1
    # the closing hint names the port's card script, not the JAX package's bench
    assert "chip_smoke.py" in out.splitlines()[-2] and "bench.py" not in out


def test_jax_drill_gives_the_same_flags(drill, tmp_path, monkeypatch):
    from realtime_whisper_asr_tpu.asr import TPUWhisperASR

    path, rep, _ = drill
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import checkpoint_drill

    _capped(TPUWhisperASR, monkeypatch)
    jax_report = str(tmp_path / "jax_drill.json")
    assert checkpoint_drill.main([path, "--work", str(tmp_path / "jax_work"),
                                  "--report", jax_report]) == 0
    with open(jax_report) as f:
        ref = json.load(f)
    assert list(ref["steps"]) == STEPS
    assert {k: v["ok"] for k, v in rep["steps"].items() if k in STEPS} == {
        k: v["ok"] for k, v in ref["steps"].items()}
    for key in ("real_tokenizer", "alignment_heads"):
        assert rep["steps"]["reload"][key] == ref["steps"]["reload"][key]
    assert rep["steps"]["prequant_artifact"]["detected"] == ref["steps"]["prequant_artifact"][
        "detected"]
