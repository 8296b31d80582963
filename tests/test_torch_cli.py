"""The port's CLI, hardware recommendations and subtitles against the JAX package's.

Mirrors the 11 cases of tests/test_cli.py on the port (``--cpu`` where a
command computes, a CUDA card's memory where the JAX test gives a TPU's),
then holds the port against the JAX package: the recommenders give the same
answers for the same memory sizes, the subtitle strings are byte-equal for
the same segments, and ``cli transcribe`` of golden clip 0 on the golden
weights prints the JAX CLI's lines.
"""

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.utils import hardware as jax_hw
from realtime_whisper_asr_tpu_torch.utils.hardware import (
    recommend_config,
    recommend_quantization,
    recommend_separation_config,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")

GPU80 = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3", "n_devices": 1,
         "compute_capability": "9.0", "hbm_bytes": 80 * 2**30}
GPU16 = dict(GPU80, hbm_bytes=16 * 2**30)
CPU = {"platform": "cpu", "device_kind": "cpu", "n_devices": 1, "hbm_bytes": None}


def test_separation_recommendation_tiers():
    assert recommend_separation_config(GPU16, "large-v3")["method"] == "none"
    assert recommend_separation_config(GPU16, "large-v3", music_expected=True)[
        "method"] == "neural"
    tight = dict(GPU16, hbm_bytes=4 * 2**30)
    assert recommend_separation_config(tight, "large-v3", music_expected=True)[
        "method"] == "filter"
    cpu_rec = recommend_separation_config(CPU, "tiny", music_expected=True)
    assert cpu_rec["method"] == "neural" and cpu_rec["variant"] == "small"


def test_quantization_recommendation():
    assert recommend_quantization(GPU80, "large-v3")["quantization"] == "int8-all"
    assert recommend_quantization(GPU80, "medium")["quantization"] == "int8-all"
    assert recommend_quantization(GPU80, "base")["quantization"] is None
    assert recommend_quantization(CPU, "tiny")["quantization"] is None


def test_wizard_persists_choices(tmp_path, monkeypatch):
    import realtime_whisper_asr_tpu_torch.cli as cli

    cfg = tmp_path / "config.json"
    answers = iter([
        "tiny",        # model
        "zh",          # language
        "",            # task -> transcribe
        "y",           # background music
        "",            # separation -> recommended
        "int8",        # quantization
        "",            # streaming mode -> default (agree2 for tiny)
        "",            # wav -> mic
    ])
    monkeypatch.setattr("builtins.input", lambda *_: next(answers))
    monkeypatch.setattr(
        "realtime_whisper_asr_tpu_torch.utils.hardware.detect_hardware", lambda: dict(GPU16))
    captured = {}
    monkeypatch.setattr(cli, "main", lambda argv: captured.update(argv=argv) or 0)

    class A:
        config = str(cfg)
        cpu = False

    assert cli.cmd_wizard(A()) == 0
    saved = json.loads(cfg.read_text())
    assert saved["model"]["size"] == "tiny"
    assert saved["model"]["quantization"] == "int8"
    assert saved["vocal_separation"]["enable"] is True
    assert saved["vocal_separation"]["method"] == "neural"
    assert saved["streaming"]["prefix_policy"] == "agree2"
    assert "--wav" not in captured["argv"]
    assert "stream" in captured["argv"]
    assert "--cpu" not in captured["argv"]


def test_stream_flags_accept_all_quantization_modes(monkeypatch):
    import realtime_whisper_asr_tpu_torch.cli as cli

    seen = []
    monkeypatch.setattr(cli, "cmd_stream", lambda args: seen.append(args.quantization) or 0)
    for q in ("int8", "int8-all", "int8-kv", "none"):
        assert cli.main(["stream", "--quantization", q, "--cpu"]) == 0
    assert seen == ["int8", "int8-all", "int8-kv", "none"]


def test_recommend_config_cpu_fallback():
    assert recommend_config(CPU)["model"] == "tiny"
    assert recommend_config(GPU16)["model"] == "large-v3"


def test_diarize_flag_sets_config(tmp_path):
    from realtime_whisper_asr_tpu_torch.cli import _add_model_args, _build_config

    p = argparse.ArgumentParser()
    _add_model_args(p)
    args = p.parse_args(["--diarize", "--config", str(tmp_path / "c.json")])
    cm = _build_config(args)
    assert cm.get("diarization.enable") is True


def _segments(asr_mod):
    return [
        asr_mod.Segment(0.0, 1.5, " hello world",
                        [asr_mod.Word(0.0, 0.7, " hello"), asr_mod.Word(0.7, 1.5, " world")]),
        asr_mod.Segment(2.0, 2.0, "   ", []),  # blank text: dropped from srt/vtt/txt
        asr_mod.Segment(3661.25, 3662.5, " again", []),
        asr_mod.Segment(-0.4, 0.0004, " 你好 \"x\"", [asr_mod.Word(1.0, 0.5, "你好")]),
    ]


def test_subtitle_formats():
    from realtime_whisper_asr_tpu_torch import asr
    from realtime_whisper_asr_tpu_torch.io.subtitles import format_segments

    segs = _segments(asr)[:3]
    srt = format_segments(segs, "srt")
    assert srt.split("\n")[0] == "1"
    assert "00:00:00,000 --> 00:00:01,500" in srt
    assert "01:01:01,250 --> 01:01:02,500" in srt
    assert srt.count("-->") == 2  # blank cue dropped, numbering stays dense
    assert "\n2\n" in srt

    vtt = format_segments(segs, "vtt")
    assert vtt.startswith("WEBVTT")
    assert "00:00:00.000 --> 00:00:01.500" in vtt

    data = json.loads(format_segments(segs, "json"))
    assert len(data["segments"]) == 3
    assert data["segments"][0]["words"][1]["word"] == " world"

    assert format_segments(segs, "txt") == "hello world\nagain"

    with pytest.raises(ValueError):
        format_segments(segs, "ass")


@pytest.mark.parametrize("fmt", ["srt", "vtt", "json", "txt"])
def test_subtitles_byte_equal_to_jax_package(fmt):
    from realtime_whisper_asr_tpu import asr as jax_asr
    from realtime_whisper_asr_tpu.io.subtitles import format_segments as jax_format
    from realtime_whisper_asr_tpu_torch import asr
    from realtime_whisper_asr_tpu_torch.io.subtitles import format_segments

    ours = format_segments(_segments(asr), fmt)
    assert ours.encode() == jax_format(_segments(jax_asr), fmt).encode()


def _stub_asr(segment_cls):
    class StubASR:
        def __init__(self, **kw):
            self.kw = kw

        def transcribe(self, audio):
            return [segment_cls(0.0, 1.0, " hi", [])]

    return StubASR


def test_cli_transcribe_output_format(tmp_path, monkeypatch):
    import realtime_whisper_asr_tpu_torch.cli as cli
    from realtime_whisper_asr_tpu_torch.asr import Segment
    from realtime_whisper_asr_tpu_torch.io import write_wav

    wav = tmp_path / "a.wav"
    write_wav(str(wav), np.zeros(16000, np.float32))
    monkeypatch.setattr("realtime_whisper_asr_tpu_torch.asr.TorchWhisperASR", _stub_asr(Segment))
    out = tmp_path / "a.srt"
    rc = cli.main([
        "transcribe", str(wav), "--model", "test-tiny", "--cpu",
        "--config", str(tmp_path / "c.json"),
        "--output-format", "srt", "--output", str(out),
    ])
    assert rc == 0
    assert out.read_text().startswith("1\n00:00:00,000 --> 00:00:01,000\nhi")


def test_cli_transcribe_output_infers_format(tmp_path, monkeypatch):
    import realtime_whisper_asr_tpu_torch.cli as cli
    from realtime_whisper_asr_tpu_torch.asr import Segment
    from realtime_whisper_asr_tpu_torch.io import write_wav

    wav = tmp_path / "a.wav"
    write_wav(str(wav), np.zeros(16000, np.float32))
    monkeypatch.setattr("realtime_whisper_asr_tpu_torch.asr.TorchWhisperASR", _stub_asr(Segment))
    out = tmp_path / "b.vtt"
    rc = cli.main(["transcribe", str(wav), "--model", "test-tiny", "--cpu",
                   "--config", str(tmp_path / "c.json"), "--output", str(out)])
    assert rc == 0
    assert out.read_text().startswith("WEBVTT")
    rc = cli.main(["transcribe", str(wav), "--model", "test-tiny", "--cpu",
                   "--config", str(tmp_path / "c.json"),
                   "--output", str(tmp_path / "b.xyz")])
    assert rc == 2


def test_cli_stream_multi_session_loop(tmp_path, monkeypatch, capsys):
    """Two sessions with a zh switch between them through the real CLI, the
    port's StreamingApp on the CPU."""
    import realtime_whisper_asr_tpu_torch.cli as cli
    import realtime_whisper_asr_tpu_torch.io as io_mod

    class FakeMic:
        exhausted = False

        def __init__(self, device=None):
            pass

        def read(self, n):
            return np.zeros(n, np.float32), False

        def close(self):
            pass

    monkeypatch.setattr(io_mod, "MicrophoneStream", FakeMic)
    monkeypatch.setattr(sys.stdin, "isatty", lambda: True)
    answers = iter(["zh", "q"])
    monkeypatch.setattr("builtins.input", lambda *_: next(answers))
    rc = cli.main(["stream", "--model", "test-tiny", "--language", "en", "--cpu",
                   "--config", str(tmp_path / "c.json"), "--max-seconds", "0.5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("session:") == 2
    assert "language → zh" in out


def test_cli_separate_writes_stem_wavs(tmp_path):
    from realtime_whisper_asr_tpu_torch import cli
    from realtime_whisper_asr_tpu_torch.io import read_wav, write_wav

    rng = np.random.default_rng(0)
    wav = tmp_path / "mix.wav"
    write_wav(str(wav), (rng.standard_normal(SR := 16000) * 0.1).astype(np.float32))
    rc = cli.main(["separate", str(wav), "--variant", "default", "--cpu",
                   "--out-dir", str(tmp_path / "stems")])
    assert rc == 0
    vocals = read_wav(str(tmp_path / "stems" / "mix.vocals.wav"))
    acc = read_wav(str(tmp_path / "stems" / "mix.accompaniment.wav"))
    assert len(vocals) == len(acc) == SR
    assert float(np.abs(vocals).max()) > 0


# ------------------------------------------------------------ against JAX


_GIB = (0, 1, 2, 4, 5, 9, 10, 16, 24, 40, 80)
_MODELS = ("tiny", "base", "small", "medium", "large-v3", "large-v3-turbo")


@pytest.mark.parametrize("gib", _GIB)
def test_recommenders_give_the_jax_answers(gib):
    """The same memory size gives the JAX package's model, dtype,
    separation method and variant, and quantization ("gpu" for "tpu")."""
    ours = dict(GPU80, hbm_bytes=gib * 2**30)
    theirs = {"platform": "tpu", "device_kind": "TPU v5e", "n_devices": 1,
              "hbm_bytes": gib * 2**30}
    keys = ("model", "dtype")
    assert ({k: recommend_config(ours)[k] for k in keys}
            == {k: jax_hw.recommend_config(theirs)[k] for k in keys})
    for model in _MODELS:
        for music in (False, True):
            for streams in (1, 8):
                a = recommend_separation_config(ours, model, music, streams)
                b = jax_hw.recommend_separation_config(theirs, model, music, streams)
                assert {k: v for k, v in a.items() if k != "reason"} == \
                    {k: v for k, v in b.items() if k != "reason"}
        assert (recommend_quantization(ours, model)["quantization"]
                == jax_hw.recommend_quantization(theirs, model)["quantization"])


def test_cpu_recommendations_give_the_jax_answers():
    theirs = {"platform": "cpu", "device_kind": "cpu", "n_devices": 8, "hbm_bytes": None}
    assert recommend_config(CPU)["model"] == jax_hw.recommend_config(theirs)["model"]
    a = recommend_separation_config(CPU, "tiny", music_expected=True)
    b = jax_hw.recommend_separation_config(theirs, "tiny", music_expected=True)
    assert {k: v for k, v in a.items() if k != "reason"} == \
        {k: v for k, v in b.items() if k != "reason"}


def test_detect_reports_the_cpu_without_cuda(monkeypatch, capsys):
    from realtime_whisper_asr_tpu_torch import cli
    from realtime_whisper_asr_tpu_torch.utils.hardware import detect_hardware

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert detect_hardware() == CPU
    assert cli.main(["detect"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["hardware"]["platform"] == "cpu"
    assert report["recommendation"]["model"] == "tiny"


@pytest.fixture(scope="module")
def golden_wav_and_checkpoint(tmp_path_factory):
    """Golden clip 0 as a WAV and the golden weights as the port's native
    checkpoint."""
    from realtime_whisper_asr_tpu_torch.io import write_wav
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import save_checkpoint
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
    from realtime_whisper_asr_tpu_torch.tools.run_eval import golden_audio

    d = tmp_path_factory.mktemp("golden_cli")
    write_wav(str(d / "g0.wav"), golden_audio(0))
    save_checkpoint(str(d / "ckpt"), load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                    get_config("test-tiny"))
    return d


def _captured(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_transcribe_prints_the_jax_cli_lines_for_golden_clip_0(golden_wav_and_checkpoint,
                                                               monkeypatch):
    """``cli transcribe`` of golden clip 0 on the golden weights (the port
    through ``--checkpoint``, the JAX CLI through its ASR built on the same
    weights) prints the same lines; their first 8 segments are the golden
    offline text."""
    import jax.numpy as jnp

    import realtime_whisper_asr_tpu.asr as jax_asr
    from realtime_whisper_asr_tpu import cli as jax_cli
    from realtime_whisper_asr_tpu.models import whisper as W
    from realtime_whisper_asr_tpu_torch import cli

    d = golden_wav_and_checkpoint
    rc, ours = _captured(cli.main, ["transcribe", str(d / "g0.wav"), "--cpu", "--dtype",
                                    "float32", "--checkpoint", str(d / "ckpt"),
                                    "--config", str(d / "c.json")])
    assert rc == 0

    tree = {}
    with np.load(os.path.join(GOLDEN, "params.npz")) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(data[key], jnp.float32)

    class GoldenASR(jax_asr.TPUWhisperASR):
        def __init__(self, model_size, checkpoint_dir, **kw):
            super().__init__(cfg=W.get_config("test-tiny"), params=tree, **kw)

    monkeypatch.setattr(jax_asr, "TPUWhisperASR", GoldenASR)
    rc, theirs = _captured(jax_cli.main, ["transcribe", str(d / "g0.wav"), "--dtype",
                                          "float32", "--config", str(d / "c.json")])
    assert rc == 0
    lines = [ln for ln in ours.splitlines() if "-->" in ln]
    assert lines and lines == [ln for ln in theirs.splitlines() if "-->" in ln]
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        golden_text = json.load(f)["clips"][0]["offline_text"]
    assert "".join(ln.split("] ", 1)[1] for ln in lines[:8]) == golden_text


def test_transcribe_srt_of_golden_clip_0(golden_wav_and_checkpoint):
    """``--output-format srt`` prints one cue per segment of the console
    listing, each with the listing's text."""
    from realtime_whisper_asr_tpu_torch import cli

    d = golden_wav_and_checkpoint
    args = ["transcribe", str(d / "g0.wav"), "--cpu", "--dtype", "float32",
            "--checkpoint", str(d / "ckpt"), "--config", str(d / "c.json")]
    _, listing = _captured(cli.main, args)
    rc, srt = _captured(cli.main, args + ["--output-format", "srt"])
    assert rc == 0
    texts = [ln.split("] ", 1)[1] for ln in listing.splitlines() if "-->" in ln]
    cues = srt.strip("\n").split("\n\n")
    assert [c.split("\n", 2)[2] for c in cues] == [t for t in texts if t]
