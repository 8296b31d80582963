"""The traffic kind end to end at test-tiny on the CPU through the
harness's internals (everything ``run.py`` does after its look for a card),
the control that has to come out not correct, and the faults that have to
make ``correct`` false. The cells serve one stream at batch 1 on one card,
so half a batch left out and an exchange between cards left out are not
faults they can have."""

from __future__ import annotations

import pytest
import torch

from conftest import make_root
from portbench.core import harness

SEED = 2**31 + 24680


def _run(tmp_path, seconds=2.0, control=False, seed=SEED, dtype="float32"):
    root, bench = make_root(tmp_path, dtype=dtype)
    return harness.run_cell(root, bench, "tiny.cell", seed, seconds, False,
                            torch.device("cpu"), 0.0, control=control, log=lambda *_: None)


def test_the_kind_runs_correct(tmp_path):
    out = _run(tmp_path)
    checks = out["checks"]
    assert out["correct"] is True, checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks["positions"]["value"] >= checks["positions"]["limit"]
    assert list(out)[-1] == "checks"
    names = {m for m in out["metrics"]}
    assert {"setup_s", "audio_throughput", "result_p50_ms"} <= names


def test_the_control_in_the_programs_place_is_not_correct(tmp_path):
    # int4 weights in the reference, judged at the served positions by the
    # same rule and limit as the program
    out = _run(tmp_path, control=True)
    checks = out["checks"]
    assert out["correct"] is False, checks
    assert "widest_gap" not in checks
    assert checks["control_widest_gap"]["value"] > checks["control_widest_gap"]["limit"]
    assert checks["structure_faults"]["value"] == 0
    assert checks["positions"]["value"] >= checks["positions"]["limit"]


def test_bf16_activations_stay_inside_the_limit(tmp_path):
    out = _run(tmp_path, dtype="bfloat16")
    assert out["correct"], out["checks"]


def _no_op_step(*args, **kwargs):
    """A decode step that returns its state unchanged."""


def _altered_select(orig):
    def select(*args, **kwargs):
        nxt, lp = orig(*args, **kwargs)
        return torch.where(nxt < 50257, (nxt + 1) % 50257, nxt), lp
    return select


@pytest.mark.parametrize("fault", ["step_unchanged", "token_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    if fault == "step_unchanged":
        monkeypatch.setattr(D, "_step", _no_op_step)
    else:
        monkeypatch.setattr(D, "_select_next", _altered_select(D._select_next))
    out = _run(tmp_path)
    assert out["correct"] is False, out["checks"]
