"""The port's evaluation harness against the JAX package's.

``normalize_text``, ``wer`` and ``cer`` give the JAX package's values
exactly on hypothesis-drawn strings; ``evaluate_offline`` and
``evaluate_streaming`` over the golden clips (the port's ASR and the JAX
package's on the golden weights, f32, 24-token caps) give the same
hypotheses, WER and CER; ``report`` the same lines but for wall times; the
port's ``tools/run_eval.py`` reproduces every golden clip and matrix row on
the CPU.
"""

import json
import os
import sys

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from realtime_whisper_asr_tpu import eval as jax_eval
from realtime_whisper_asr_tpu_torch import eval as port_eval

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TEXT = st.text(alphabet=st.sampled_from(list("abc ABC'.,!?-xé你好\t\n0")), max_size=40)


@settings(max_examples=300, deadline=None)
@given(_TEXT)
def test_normalize_text_equals_jax(s):
    assert port_eval.normalize_text(s) == jax_eval.normalize_text(s)


@settings(max_examples=300, deadline=None)
@given(_TEXT, _TEXT, st.booleans())
def test_wer_and_cer_equal_jax(ref, hyp, normalize):
    assert port_eval.wer(ref, hyp, normalize) == jax_eval.wer(ref, hyp, normalize)
    assert port_eval.cer(ref, hyp, normalize) == jax_eval.cer(ref, hyp, normalize)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 3), max_size=12), st.lists(st.integers(0, 3), max_size=12))
def test_edit_distance_equals_jax(ref, hyp):
    assert port_eval.edit_distance(ref, hyp) == jax_eval.edit_distance(ref, hyp)


def test_wer_known_values():
    assert port_eval.wer("a b c", "a b c") == 0.0
    assert port_eval.wer("a b c", "a x c") == pytest.approx(1 / 3)
    assert port_eval.wer("", "") == 0.0 and port_eval.wer("", "x") == 1.0
    assert port_eval.cer("abc", "abd") == pytest.approx(1 / 3)


@pytest.fixture(scope="module")
def asrs():
    """(the port's golden ASR on the CPU, the JAX package's)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden

    from realtime_whisper_asr_tpu_torch.tools import run_eval

    return run_eval.build_asr("cpu"), golden.build_asr()


def _manifest():
    from realtime_whisper_asr_tpu_torch.tools.run_eval import golden_audio

    with open(os.path.join(ROOT, "tests", "fixtures", "golden", "transcripts.json")) as f:
        clips = json.load(f)["clips"]
    return [(f"golden{c['idx']}", golden_audio(c["idx"]), c["offline_text"]) for c in clips]


def _same(ours, theirs):
    assert [(r.name, r.hypothesis, r.reference, r.wer, r.cer, r.audio_seconds) for r in ours] \
        == [(r.name, r.hypothesis, r.reference, r.wer, r.cer, r.audio_seconds) for r in theirs]


def _report_without_times(text: str) -> list:
    rows = [json.loads(line) for line in text.splitlines()]
    return [{k: v for k, v in r.items() if k not in ("wall_s", "rtf", "p50_ms")} for r in rows]


def test_evaluate_offline_equals_jax(asrs):
    ours, theirs = asrs
    a = port_eval.evaluate_offline(ours, _manifest())
    b = jax_eval.evaluate_offline(theirs, _manifest())
    _same(a, b)
    assert all(r.wer == 0.0 for r in a)  # the golden offline text is the reference
    assert _report_without_times(port_eval.report(a)) == \
        _report_without_times(jax_eval.report(b))


def test_evaluate_streaming_equals_jax(asrs):
    from realtime_whisper_asr_tpu.streaming import OnlineASRProcessor as JaxOnline
    from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

    ours, theirs = asrs

    def keyed(asr, cls, prefix):
        count = iter(range(100))

        def make():
            asr.set_active_stream(f"{prefix}{next(count)}")
            return cls(asr, buffer_trimming=("segment", 15.0))

        return make

    a = port_eval.evaluate_streaming(keyed(ours, OnlineASRProcessor, "p"), _manifest())
    b = jax_eval.evaluate_streaming(keyed(theirs, JaxOnline, "j"), _manifest())
    _same(a, b)
    assert all(r.p50_latency_ms is not None for r in a)


def test_run_eval_reproduces_the_fixture(tmp_path):
    from realtime_whisper_asr_tpu_torch.tools import run_eval

    out = tmp_path / "eval.json"
    assert run_eval.main(["--cpu", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["all_reproduced"] is True
    assert [m["row"] for m in data["matrix"]] == [
        "beam5", "translate", "long_window", "int8all", "prequant", "int4", "vac",
        "pipeline_exact", "pipeline_async", "diarize"]
    assert data["harness_selfcheck"] == {"wer_identity": 0.0, "wer_one_sub": 1 / 3,
                                         "cer_identity": 0.0}
