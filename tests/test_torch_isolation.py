"""The port stands alone and runs on the card unless asked otherwise.

- Importing every module of ``realtime_whisper_asr_tpu_torch`` (and
  ``chip_smoke.py``) pulls in neither ``jax`` nor the JAX package, and
  works with ``safetensors``, ``transformers`` and ``orbax`` absent; nor do
  the serving modules (``serving``, ``serving_tcp``, ``serving_ws``,
  ``pipeline``, ``services``) alone. The name check is exact: the port's
  own name starts with the JAX package's.
- Entry points default to CUDA and raise on a host without it; the
  servers' CLIs too. Their ``--diarize`` and ``--separation`` flags build
  a server with speaker labels and the separation frontend (they raised
  ``NotImplementedError`` before the application path was ported).
- The application path's modules (``app``, ``io``, ``config``, the
  separation, dedup, speech-rate and speaker stages) import no ``jax`` on
  their own; ``StreamingApp()`` and ``NeuralSeparator()`` raise without
  CUDA; the device paths of the DSP ops, the separators, the dedup gate and
  the time stretch have no ``try`` that could fall back to the CPU or to
  unseparated audio.
- The kernel wrappers (log-mel, packed-int4 matmul, matmul chain), the int8
  product and the quantized modules' dispatch have no ``try``/``except`` that
  could fall back from a kernel to its plain version; nor have the VAD and
  the device audio ring one that could fall back to the CPU. The sampler
  (``ops/threefry.py``) and the beam search (``beam.py``) have neither a
  handler nor a branch on the device's type. The server's handlers only
  count a failed group and reset it.
- The CLI, evaluation and training modules import neither ``jax`` nor
  ``optax`` nor ``orbax``; the CLI's computing commands exit with status 2
  without CUDA unless given ``--cpu``; ``make_train_state``,
  ``make_train_step``, ``prepare_batch`` and the finetune, train_vad and
  run_eval mains raise without CUDA unless asked for the CPU;
  ``prepare_batch`` reaches the log-mel wrapper only (no path to the plain
  version for a CUDA row), and the training code has no handler.
- The speaker and separator trainers, calibration, the checkpoint drill,
  the soak and the three examples import neither ``jax`` nor ``optax`` and
  raise without CUDA unless asked for the CPU; the tools have no handler.
- The ``parallel`` package imports neither ``jax`` nor the JAX package;
  ``init_distributed`` and ``finetune --mesh`` / ``--pipeline-stages``
  raise without CUDA unless asked for the CPU; no ``try`` in the package
  could fall back from NCCL to gloo (or from a mesh to one device), and the
  backend follows the device alone.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from realtime_whisper_asr_tpu_torch import asr as asr_mod
from realtime_whisper_asr_tpu_torch.models.vad import silero_like
from realtime_whisper_asr_tpu_torch.models.whisper import model as model_mod
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper import beam
from realtime_whisper_asr_tpu_torch.ops import (
    int4_matmul,
    int8_matmul,
    logmel,
    matmul_chain,
    threefry,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, runpy, sys
import realtime_whisper_asr_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="not_main")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "realtime_whisper_asr_tpu" or m.startswith("realtime_whisper_asr_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 10 else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_BLOCKED = r"""
import sys
for name in ("safetensors", "transformers", "orbax"):  # absent on the card's machine
    sys.modules[name] = None
import importlib, pkgutil, runpy
import realtime_whisper_asr_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="not_main")
sys.exit(0 if len(names) >= 10 else 1)
"""


def test_port_imports_without_safetensors_transformers_orbax():
    """Every module of the port, and chip_smoke.py, imports with
    ``safetensors``, ``transformers`` and ``orbax`` unimportable, as on the
    card's machine: the checkpoint loaders read safetensors with the port's
    own reader."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_BLOCKED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("test-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        asr_mod.TorchWhisperASR(cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_mod.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        silero_like.SileroLikeVAD()
    with pytest.raises(RuntimeError, match="CUDA"):
        silero_like.SileroLikeNet()


@pytest.mark.parametrize("entry", [
    "train_speaker", "train_separator", "calibrate", "checkpoint_drill", "soak",
    "offline_transcribe", "streaming_from_wav", "serving_multistream",
])
def test_tools_and_examples_refuse_missing_cuda(monkeypatch, tmp_path, entry):
    """The offline trainers, calibration, the checkpoint drill, the soak and
    the examples, run without ``--cpu`` on a host without CUDA, raise before
    they compute anything."""
    from realtime_whisper_asr_tpu_torch.examples import (
        offline_transcribe,
        serving_multistream,
        streaming_from_wav,
    )
    from realtime_whisper_asr_tpu_torch.tools import (
        calibrate,
        checkpoint_drill,
        soak,
        train_separator,
        train_speaker,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "train_speaker": lambda: train_speaker.main(["--out", str(tmp_path / "s.npz")]),
        "train_separator": lambda: train_separator.main(["--out", str(tmp_path / "p.npz")]),
        "calibrate": lambda: calibrate.main([str(tmp_path / "cal"), "--synth"]),
        "checkpoint_drill": lambda: checkpoint_drill.main(["hf", "--work", str(tmp_path)]),
        "soak": lambda: soak.run_soak(0.1),
        "offline_transcribe": lambda: offline_transcribe.main(["a.wav", "--model", "test-tiny"]),
        "streaming_from_wav": lambda: streaming_from_wav.main(["a.wav", "--model", "test-tiny"]),
        "serving_multistream": lambda: serving_multistream.main(["--model", "test-tiny"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not os.listdir(tmp_path)


def test_vad_and_ring_have_no_fallback():
    with open(silero_like.__file__) as f:
        assert not [n for n in ast.walk(ast.parse(f.read())) if isinstance(n, ast.Try)]
    with open(asr_mod.__file__) as f:
        tree = ast.parse(f.read())
    names = {"_ring_shift_write", "_find_shift", "_plan_upload", "_sync_many",
             "_upload_and_apply", "prefetch_audio", "_sync_audio_and_aux", "_encode_from_buf",
             "_encode_many"}
    nodes = [n for n in ast.walk(tree) if getattr(n, "name", None) in names]
    assert len(nodes) == len(names)
    assert not [n for node in nodes for n in ast.walk(node) if isinstance(n, ast.Try)]


def test_logmel_wrapper_has_no_fallback():
    with open(logmel.__file__) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("mod", [int4_matmul, matmul_chain, int8_matmul],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_kernel_wrappers_have_no_fallback(mod):
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("mod", [threefry, beam], ids=["threefry", "beam"])
def test_sampler_and_beam_have_no_device_branch(mod):
    """The same code runs on a CPU and a CUDA tensor: no handler, and no
    branch on a tensor's device type."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr == "type"]
    assert "cpu" not in ast.unparse(tree).replace("CPU", "")


def test_quantized_linear_dispatch_has_no_fallback():
    with open(model_mod.__file__) as f:
        tree = ast.parse(f.read())
    names = {"_QuantLinear", "Int8Linear", "Int4Linear", "Int8Embedding", "_quantize_linears"}
    nodes = [n for n in tree.body if getattr(n, "name", None) in names]
    assert len(nodes) == len(names)
    assert not [n for node in nodes for n in ast.walk(node) if isinstance(n, ast.Try)]


def test_logmel_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        logmel.log_mel_spectrogram(torch.zeros(16000, device="meta"))


_IMPORT_SERVING = r"""
import importlib, sys
for name in ("serving", "serving_tcp", "serving_ws", "pipeline", "services"):
    importlib.import_module("realtime_whisper_asr_tpu_torch." + name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "realtime_whisper_asr_tpu" or m.startswith("realtime_whisper_asr_tpu."))
sys.exit(1 if bad else 0)
"""


def test_serving_modules_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SERVING], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("args,error,match", [
    ([], RuntimeError, "CUDA"),
    (["--checkpoint", "ckpt"], FileNotFoundError, "ckpt"),
    (["--diarize"], RuntimeError, "CUDA"),
    (["--separation", "filter"], RuntimeError, "CUDA"),
], ids=["no-cuda", "checkpoint", "diarize", "separation"])
@pytest.mark.parametrize("module", ["serving_tcp", "serving_ws"])
def test_serving_mains_refuse(monkeypatch, module, args, error, match):
    """The servers' CLIs build the ASR on the card (and raise without CUDA),
    and raise for a checkpoint directory that is not there. ``--diarize``
    and ``--separation`` no longer refuse: they reach the ASR's build, which
    raises without CUDA (``test_serving_mains_build_diarize_and_separation``
    runs them on the CPU)."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    with pytest.raises(error, match=match):
        mod.main(["--model", "test-tiny", "--port", "0"] + args)


@pytest.mark.parametrize("module", ["serving_tcp", "serving_ws"])
def test_serving_flags_are_all_read(module):
    """Every flag a server's CLI accepts is read by the code that builds the
    server: none is parsed and then ignored."""
    import importlib
    import inspect

    from realtime_whisper_asr_tpu_torch import serving_tcp

    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    source = inspect.getsource(serving_tcp._stream_server) + inspect.getsource(mod.main)
    dests = [a.dest for a in serving_tcp._parser("x", 0)._actions if a.dest != "help"]
    assert dests and all(f"args.{d}" in source for d in dests), dests


def test_server_has_no_fallback():
    """The server's only handlers: the round-robin rotate racing a close
    (``ValueError``), and the three group handlers, which count the failure
    and reset the group; none calls the backend again."""
    from realtime_whisper_asr_tpu_torch import serving

    with open(serving.__file__) as f:
        tree = ast.parse(f.read())
    owners = {}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Try):
                    owners[node] = fn.name
    assert sorted(owners.values()) == ["_collect_ready", "_dispatch_batch", "_finalize_batch",
                                       "_tick_batch"]
    for node, name in owners.items():
        (handler,) = node.handlers
        text = ast.unparse(handler)
        if name == "_collect_ready":
            assert ast.unparse(handler.type) == "ValueError"
            continue
        assert "self.group_failures += 1" in text and "self._reset_group(group)" in text
        assert "asr" not in text.replace("batched", "")


@pytest.mark.parametrize("separation", ["neural", "filter"])
@pytest.mark.parametrize("module", ["serving_tcp", "serving_ws"])
def test_serving_mains_build_diarize_and_separation(module, separation):
    """``--diarize --separation ...`` on the CPU: a server whose streams get
    speaker trackers, with the trained net fused into the ASR's encode
    (``neural``) or the host band-pass on every fed chunk (``filter``)."""
    import importlib

    import numpy as np

    from realtime_whisper_asr_tpu_torch import serving_tcp

    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    assert mod._stream_server is serving_tcp._stream_server
    args = serving_tcp._parser("x", 0).parse_args(
        ["--model", "test-tiny", "--device", "cpu", "--quantization", "none", "--diarize",
         "--separation", separation])
    server = mod._stream_server(args)
    assert server.fused_separation == (separation == "neural")
    if separation == "neural":
        assert server.separator is None and server.asr._sep_frontend is not None
        assert server.get_stats()["separator"] == {"fused": True}
    else:
        assert server.separator.name == "filter" and not server.separator.use_device
    sid = server.create_stream()
    assert server.streams[sid].diarizer is not None
    server.feed(sid, np.zeros(16000, np.float32))
    server.close_stream(sid)
    assert server.group_failures == 0


_IMPORT_APP = r"""
import importlib, sys
for name in ("app", "io", "config", "ops.dsp", "ops.features", "models.separation_nn",
             "models.speaker", "pipeline.separation", "pipeline.dedup_audio",
             "pipeline.speech_rate", "pipeline.stretch", "services.translation"):
    importlib.import_module("realtime_whisper_asr_tpu_torch." + name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "realtime_whisper_asr_tpu" or m.startswith("realtime_whisper_asr_tpu.")
             or m == "requests")
sys.exit(1 if bad else 0)
"""


def test_app_path_modules_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_APP], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_app_path_entry_points_refuse_missing_cuda(monkeypatch):
    from realtime_whisper_asr_tpu_torch.app import StreamingApp
    from realtime_whisper_asr_tpu_torch.models.separation_nn import NeuralSeparator
    from realtime_whisper_asr_tpu_torch.pipeline import (
        AudioDeduplicator,
        BandpassSeparator,
        SpeechRateAudioProcessor,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (StreamingApp, NeuralSeparator, BandpassSeparator, SpeechRateAudioProcessor,
                 lambda: AudioDeduplicator(use_device=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the host paths need no card
    assert NeuralSeparator(use_device=False).device is None
    assert BandpassSeparator(use_device=False).device is None
    assert AudioDeduplicator().device is None


def _tries(path, names=None):
    with open(path) as f:
        tree = ast.parse(f.read())
    if names is None:
        return [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    nodes = [n for n in ast.walk(tree) if getattr(n, "name", None) in names]
    assert len(nodes) == len(names), [n.name for n in nodes]
    return [t for node in nodes for t in ast.walk(node) if isinstance(t, ast.Try)]


@pytest.mark.parametrize("module", ["ops.dsp", "ops.features", "models.separation_nn",
                                    "pipeline.dedup_audio", "pipeline.stretch"])
def test_app_path_device_code_has_no_fallback(module):
    import importlib

    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    assert not _tries(mod.__file__)


def test_separators_have_no_fallback():
    """pipeline/separation.py: no handler in the separators' device paths,
    the factory or the windowing; the one ``try`` is DemucsSeparator's
    import of the optional ``demucs`` package."""
    from realtime_whisper_asr_tpu_torch.pipeline import separation

    with open(separation.__file__) as f:
        tree = ast.parse(f.read())
    owners = [fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
              for node in ast.walk(fn) if isinstance(node, ast.Try)]
    assert owners == ["__init__"]
    demucs = next(n for n in ast.walk(tree) if getattr(n, "name", None) == "DemucsSeparator")
    assert len([n for n in ast.walk(demucs) if isinstance(n, ast.Try)]) == 1


_IMPORT_TRAIN_CLI = r"""
import importlib, sys
for name in ("cli", "eval", "utils.hardware", "utils.log_filter", "io.subtitles", "train",
             "train.optim", "train.train_step", "train.data", "tools.finetune",
             "tools.train_vad", "tools.run_eval", "tools.train_speaker",
             "tools.train_separator", "tools.calibrate", "tools.checkpoint_drill", "tools.soak",
             "examples.offline_transcribe", "examples.streaming_from_wav",
             "examples.serving_multistream", "parallel", "parallel.mesh",
             "parallel.collectives", "parallel.sharding", "parallel.tp", "parallel.pipeline"):
    importlib.import_module("realtime_whisper_asr_tpu_torch." + name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax")
             or m == "realtime_whisper_asr_tpu" or m.startswith("realtime_whisper_asr_tpu."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_cli_eval_and_training_modules_import_no_jax_optax_orbax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN_CLI], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("argv", [
    ["transcribe", "a.wav", "--model", "test-tiny"],
    ["stream", "--model", "test-tiny", "--wav", "a.wav"],
    ["separate", "a.wav"],
    ["wizard"],
], ids=["transcribe", "stream", "separate", "wizard"])
def test_cli_commands_refuse_missing_cuda_without_cpu_flag(monkeypatch, capsys, argv):
    """A command that computes exits with status 2 and the device
    message before it reads a file or builds a model; ``detect`` and
    ``devices`` compute nothing and run."""
    from realtime_whisper_asr_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--cpu" in err
    assert cli.main(["detect"]) == 0


def test_training_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    import numpy as np

    from realtime_whisper_asr_tpu_torch.tools import finetune, run_eval, train_vad
    from realtime_whisper_asr_tpu_torch.train import data, train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("test-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_step.make_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_step.make_train_step(cfg)
    batch = {"audio": np.zeros((1, 16000), np.float32), "mask": np.ones((1, 4), np.float32),
             "tokens_in": np.zeros((1, 4), np.int32), "tokens_out": np.zeros((1, 4), np.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        data.prepare_batch(batch, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.main(["--manifest", "m.jsonl", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vad.main(["--steps", "1", "--out", str(tmp_path / "v.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval.main(["--out", str(tmp_path / "e.json")])


def test_prepare_batch_has_no_path_to_the_plain_logmel():
    """``prepare_batch`` calls the log-mel wrapper only: no reference to the
    plain version, no handler, no branch on a device type, so a CUDA row
    launches K1 (the wrapper itself has no fallback either)."""
    import inspect

    from realtime_whisper_asr_tpu_torch.train import data

    src = inspect.getsource(data.prepare_batch)
    tree = ast.parse(src)
    calls = {ast.unparse(n.func) for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert "log_mel_spectrogram" in calls
    assert "_plain" not in src and "_log10_mel" not in src
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr == "type"]


@pytest.mark.parametrize("module", ["train.optim", "train.train_step", "tools.finetune",
                                    "tools.train_vad", "tools.train_speaker",
                                    "tools.train_separator", "tools.calibrate",
                                    "tools.checkpoint_drill", "tools.soak"])
def test_training_code_has_no_fallback(module):
    import importlib

    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    assert not _tries(mod.__file__)


def test_parallel_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    import torch.distributed as dist

    from realtime_whisper_asr_tpu_torch.parallel import init_distributed
    from realtime_whisper_asr_tpu_torch.tools import finetune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed(store=dist.HashStore(), rank=0, world_size=1)
    for flags in (["--mesh", "1x1"], ["--sequence-parallel"], ["--pipeline-stages", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            finetune.main(["--manifest", "m.jsonl", "--out", str(tmp_path)] + flags)
    assert not dist.is_initialized()


@pytest.mark.parametrize("module", ["parallel.mesh", "parallel.collectives",
                                    "parallel.sharding", "parallel.tp", "parallel.pipeline"])
def test_parallel_code_has_no_fallback(module):
    """No handler anywhere in the package (a ``try`` only to restore a flag
    in its ``finally``); the one choice of backend in ``init_distributed``
    is made on the device's type."""
    import importlib
    import inspect

    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    assert not [t for t in _tries(mod.__file__) if t.handlers]
    if module == "parallel.mesh":
        src = inspect.getsource(mod.init_distributed)
        branches = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.If)
                    and "nccl" in ast.unparse(n)]
        assert len(branches) == 1 and ast.unparse(branches[0].test) == "dev.type == 'cuda'"
        assert "gloo" in ast.unparse(branches[0].orelse[0])
