"""The port's native checkpoint format and pre-quantized artifacts.

- A native round trip of every tier on the golden weights, equal leaf for
  leaf; loaded with ``dtype=bf16`` the floats are bf16 and the scales of the
  quantized weights stay f32.
- ``quant.detect_quantization`` equal to the JAX package's on the same
  weights, and ``quant.quantize`` idempotent (int8 to int4 through the
  dequantized weight, as the JAX package's tier transforms).
- The rank rule of pre-quantized artifacts (``realtime_whisper_asr_tpu/asr.py``):
  an artifact is never weakened; an ``int8-all`` artifact asked for
  ``int8-kv`` runs ``int8-kv``.
- The JAX package's orbax checkpoint carried across: JAX ``save_checkpoint``
  → JAX ``load_checkpoint`` → ``params_from_jax`` → port save → port load,
  equal; the orbax directory itself is refused with the conversion named.
- The golden ``prequant`` row: the ``int8-all`` model saved in the port's
  format and reloaded reproduces the row, and the row matches ``int8all``.
- The CLIs: the port's ``tools/convert_checkpoint.py`` end to end on a tiny
  HF directory, and the TCP and WebSocket servers built from
  ``--checkpoint`` on the CPU path.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import quant as JQ
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import checkpoint as CK
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz, params_from_jax
from tests.test_torch_decode_loop import _golden_tree, golden_audio
from tests.test_torch_load import _assert_states_equal, hf_dir

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TIERS = [None, "int8", "int8-all", "int8-kv", "int4", "int4-all"]
JAX_TIERS = {"int8": JQ.quantize_decoder, "int8-all": JQ.quantize_all,
             "int4": JQ.quantize_decoder_int4, "int4-all": JQ.quantize_all_int4}


def _golden_state() -> dict:
    return load_flat_npz(os.path.join(GOLDEN, "params.npz"))


@pytest.mark.parametrize("tier", TIERS, ids=lambda t: t or "dense")
def test_native_round_trip(tmp_path, tier):
    cfg = C.get_config("test-tiny")
    state = Q.quantize(_golden_state(), tier)
    CK.save_checkpoint(str(tmp_path), state, cfg)
    assert CK.is_native_checkpoint(str(tmp_path))
    got_cfg, got = CK.load_checkpoint(str(tmp_path))
    assert got_cfg == cfg
    _assert_states_equal(got, state)
    _, bf16 = CK.load_checkpoint(str(tmp_path), torch.bfloat16)
    for key, t in bf16.items():
        if key.endswith(".s") and key[:-1] + "q" in bf16:
            assert t.dtype == torch.float32 and torch.equal(t, state[key]), key
        elif state[key].is_floating_point():
            assert t.dtype == torch.bfloat16 and torch.equal(t, state[key].bfloat16()), key
        else:
            assert torch.equal(t, state[key]), key


@pytest.mark.parametrize("tier", [None] + list(JAX_TIERS), ids=lambda t: t or "dense")
def test_detect_quantization_equals_jax(tier):
    tree = jax.tree.map(jnp.asarray, _golden_tree())
    jtree = JQ.fuse_qkv(JAX_TIERS[tier](tree) if tier else tree)
    state = Q.quantize(_golden_state(), tier)
    assert Q.detect_quantization(state) == JQ.detect_quantization(jtree) == tier
    assert Q.detect_quantization(Q.quantize(_golden_state(), "int8-kv")) == "int8-all"


@pytest.mark.parametrize("tier", TIERS[1:])
def test_quantize_is_idempotent(tier):
    once = Q.quantize(_golden_state(), tier)
    _assert_states_equal(Q.quantize(once, tier), once)


@pytest.mark.parametrize("first,then", [("int8-all", "int4"), ("int8", "int4-all"),
                                        ("int4", "int8-all"), ("int8", "int8-all")])
def test_quantize_on_a_quantized_state_equals_jax(first, then):
    """A tier applied to another tier's output gives the JAX package's
    transforms composed the same way (int8 linears requantized to int4
    through their dequantized weights; quantized linears left as they are
    by int8)."""
    tree = jax.tree.map(jnp.asarray, _golden_tree())
    jtree = JQ.fuse_qkv(JAX_TIERS[then](JAX_TIERS[first](tree)))
    ref = params_from_jax(jax.tree.map(np.asarray, jtree))
    _assert_states_equal(Q.quantize(Q.quantize(_golden_state(), first), then), ref)


#: (artifact tier, requested tier) -> what runs, as the JAX backend's rank
#: table decides (realtime_whisper_asr_tpu/asr.py:219-238)
RANK_CASES = [
    ("int8-all", None, "int8-all"), ("int8-all", "int8", "int8-all"),
    ("int8-all", "int8-kv", "int8-kv"), ("int8-all", "int4", "int4"),
    ("int8", "int8-kv", "int8-kv"), ("int4", "int8-kv", "int4"),
    ("int4", "int4-all", "int4-all"), ("int4-all", "int4", "int4-all"),
    (None, "int8-kv", "int8-kv"),
]


@pytest.mark.parametrize("artifact,requested,runs", RANK_CASES)
def test_prequantized_artifact_is_never_weakened(tmp_path, artifact, requested, runs):
    cfg = C.get_config("test-tiny")
    CK.save_checkpoint(str(tmp_path), Q.quantize(_golden_state(), artifact), cfg)
    asr = TorchWhisperASR(checkpoint_dir=str(tmp_path), dtype=torch.float32, device="cpu",
                          quantization=requested)
    assert asr.quantization == runs
    assert asr.model.kv_quant == (runs == "int8-kv")
    # the model holds the requested transform of the artifact, as the JAX
    # package's idempotent transforms compose
    want = Q.quantize(Q.quantize(_golden_state(), artifact), runs)
    got = asr.model.state_dict()
    for key, value in want.items():
        if key == "decoder.tok_emb.q":  # the model pads the vocabulary rows to 8
            value = torch.nn.functional.pad(value, (0, 0, 0, got[key].shape[0] - value.shape[0]))
        assert torch.equal(got[key], value), key


def test_orbax_checkpoint_carried_across_and_refused(tmp_path):
    from realtime_whisper_asr_tpu.models.whisper import checkpoint as JCK

    jcfg = W.get_config("test-tiny")
    tree = JQ.quantize_all(jax.tree.map(jnp.asarray, _golden_tree()))
    orbax_dir = str(tmp_path / "orbax")
    JCK.save_checkpoint(orbax_dir, tree, jcfg)
    cfg_j, restored = JCK.load_checkpoint(orbax_dir)
    state = params_from_jax(jax.tree.map(np.asarray, restored))
    port_dir = str(tmp_path / "port")
    CK.save_checkpoint(port_dir, state, C.get_config("test-tiny"))
    cfg, got = CK.load_checkpoint(port_dir)
    assert cfg == C.WhisperConfig(**json.load(open(os.path.join(orbax_dir, "rtwa_config.json"))))
    _assert_states_equal(got, params_from_jax(jax.tree.map(np.asarray, tree)))
    assert CK.is_native_checkpoint(orbax_dir)
    with pytest.raises(ValueError, match="orbax.*params_from_jax"):
        TorchWhisperASR(checkpoint_dir=orbax_dir, dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        TorchWhisperASR(checkpoint_dir=str(tmp_path / "absent"), device="cpu")


def test_golden_prequant_row(tmp_path):
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        matrix = json.load(f)["matrix"]
    cfg = C.get_config("test-tiny")
    asr8 = TorchWhisperASR(cfg=cfg, dtype=torch.float32, device="cpu", params=_golden_state(),
                           quantization="int8-all")
    CK.save_checkpoint(str(tmp_path), asr8.model.state_dict(), cfg)
    asr = TorchWhisperASR(checkpoint_dir=str(tmp_path), dtype=torch.float32, device="cpu")
    assert asr.quantization == "int8-all"
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    res = asr.transcribe(golden_audio(0))
    row = {"tokens": [int(t) for t in res.tokens], "text": "".join(s.text for s in res).strip()}
    row["matches_int8all"] = row["tokens"] == matrix["int8all"]["tokens"]
    assert row == matrix["prequant"]
    assert row["matches_int8all"]


def test_convert_tool_end_to_end(tmp_path, capsys):
    from realtime_whisper_asr_tpu_torch.tools import convert_checkpoint as tool

    src = hf_dir(tmp_path, alignment_heads=[[1, 0]])
    for quantize, tier in (("int8-all", "int8-all"), ("int4", "int4"), ("none", None)):
        dst = str(tmp_path / f"out-{quantize}")
        assert tool.main([src, dst, "--quantize", quantize, "--dtype", "float32",
                          "--device", "cpu"]) == 0
        assert f"quantization={tier}" in capsys.readouterr().out
        assert os.path.exists(os.path.join(dst, "generation_config.json"))
        artifact = TorchWhisperASR(checkpoint_dir=dst, dtype=torch.float32, device="cpu")
        at_load = TorchWhisperASR(checkpoint_dir=src, dtype=torch.float32, device="cpu",
                                  quantization=tier)
        assert artifact.quantization == at_load.quantization == tier
        _assert_states_equal(artifact.model.state_dict(), at_load.model.state_dict())
        np.testing.assert_array_equal(artifact.alignment_heads, at_load.alignment_heads)
    again = str(tmp_path / "again")  # a native checkpoint in, re-saved in bf16
    assert tool.main([str(tmp_path / "out-none"), again, "--quantize", "int8",
                      "--device", "cpu"]) == 0
    assert "quantization=int8" in capsys.readouterr().out
    assert CK.load_checkpoint(again)[1]["decoder.pos_emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("module", ["serving_tcp", "serving_ws"])
def test_serving_cli_builds_from_checkpoint(tmp_path, monkeypatch, module):
    """``main --checkpoint DIR --device cpu`` builds the server over the
    checkpoint's model (its serve loop replaced by a stub that records it);
    ``--quantization int8-kv`` runs the tier. The default device stays the
    card."""
    import importlib

    from realtime_whisper_asr_tpu_torch import serving_tcp

    mod = importlib.import_module("realtime_whisper_asr_tpu_torch." + module)
    cls = mod.TCPTranscriptionServer if module == "serving_tcp" else mod.WSTranscriptionServer
    built = []

    def serve(self):
        built.append(self.stream_server)
        self.server_close()

    monkeypatch.setattr(cls, "serve", serve)
    path = hf_dir(tmp_path, alignment_heads=[[1, 1]])
    assert mod.main(["--checkpoint", path, "--device", "cpu", "--port", "0",
                     "--quantization", "int8-kv"]) == 0
    asr = built[0].asr
    assert asr.quantization == "int8-kv" and asr.model.kv_quant
    assert asr.cfg.n_audio_state == 64 and asr.alignment_heads[1, 1] == 1.0
    assert serving_tcp._parser("x", 0).parse_args([]).device == "cuda"
    assert asr.device == torch.device("cpu")
