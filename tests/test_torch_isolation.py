"""The port stands alone and runs on the card unless asked otherwise.

- Importing every module of ``realtime_whisper_asr_tpu_torch`` (and
  ``chip_smoke.py``) pulls in neither ``jax`` nor the JAX package. The name
  check is exact: the port's own name starts with the JAX package's.
- Entry points default to CUDA and raise on a host without it.
- The kernel wrappers (log-mel, packed-int4 matmul, matmul chain), the int8
  product and the quantized modules' dispatch have no ``try``/``except`` that
  could fall back from a kernel to its plain version; nor have the VAD and
  the device audio ring one that could fall back to the CPU.
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
from realtime_whisper_asr_tpu_torch.ops import int4_matmul, int8_matmul, logmel, matmul_chain

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


def test_vad_and_ring_have_no_fallback():
    with open(silero_like.__file__) as f:
        assert not [n for n in ast.walk(ast.parse(f.read())) if isinstance(n, ast.Try)]
    with open(asr_mod.__file__) as f:
        tree = ast.parse(f.read())
    names = {"_ring_shift_write", "_find_shift", "_plan_upload", "_sync_many",
             "_upload_and_apply", "prefetch_audio", "_sync_audio_and_aux", "_encode_from_buf"}
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
