"""The port's examples run with ``--cpu`` on the golden test-tiny weights
(the port's native checkpoint), and ``offline_transcribe`` prints golden
clip 0's recorded text (f32, as the golden rows were recorded)."""

import contextlib
import io
import json
import os

import pytest
import torch

from realtime_whisper_asr_tpu_torch.examples import (
    offline_transcribe,
    serving_multistream,
    streaming_from_wav,
)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """(golden clip 0 as a WAV, the golden weights as a native checkpoint)."""
    from realtime_whisper_asr_tpu_torch.io import write_wav
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import save_checkpoint
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
    from realtime_whisper_asr_tpu_torch.tools.run_eval import golden_audio

    d = tmp_path_factory.mktemp("examples")
    write_wav(str(d / "g0.wav"), golden_audio(0))
    save_checkpoint(str(d / "ckpt"), load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                    get_config("test-tiny"))
    return str(d / "g0.wav"), str(d / "ckpt")


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_offline_transcribe_prints_the_golden_text(golden):
    wav, ckpt = golden
    out = _run(offline_transcribe.main, [wav, "--checkpoint", ckpt, "--dtype", "float32",
                                         "--cpu"])
    lines = [ln for ln in out.splitlines() if "-->" in ln]
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        golden_text = json.load(f)["clips"][0]["offline_text"]
    assert "".join(ln.split("] ", 1)[1] for ln in lines[:8]) == golden_text


def test_streaming_from_wav_runs_a_session(golden):
    wav, ckpt = golden
    out = _run(streaming_from_wav.main, [wav, "--checkpoint", ckpt, "--cpu"])
    assert "8.0s audio" in out.splitlines()[-1]


def test_serving_multistream_serves_two_streams(golden):
    """Both streams get speaker-labeled results; no group fails."""
    _, ckpt = golden
    out = _run(serving_multistream.main, ["--checkpoint", ckpt, "--cpu"])
    results = [ln for ln in out.splitlines() if ln.startswith("stream ")]
    assert {ln.split()[1] for ln in results} == {"1", "2"}
    assert any(" [S" in ln for ln in results)
    last = out.splitlines()[-1]
    assert last.startswith("stats: ") and "'group_failures': 0" in last
