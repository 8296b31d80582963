"""HF checkpoint directories through the port's loader (``load.py``) and its
safetensors reader and writer (``safetensors_io.py``), against the JAX
package's loader and the ``safetensors`` package.

- Every leaf of ``load_checkpoint_dir`` equals
  ``convert.params_from_jax(JAX load_checkpoint_dir(...))`` bit for bit, at
  f32 and bf16, on random HF checkpoints written by ``transformers``:
  ``WhisperModel`` and ``WhisperForConditionalGeneration`` (its ``model.``
  prefix and tied ``proj_out``), one file or several.
- The reader and the writer against ``safetensors`` both ways, for every
  dtype the port takes.
- ``TorchWhisperASR(checkpoint_dir=...)``: the alignment heads of
  ``generation_config.json`` (None for a malformed file) and the tokenizer
  files of the directory.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import load as L
from realtime_whisper_asr_tpu_torch.models.whisper.convert import params_from_jax
from realtime_whisper_asr_tpu_torch.models.whisper.safetensors_io import (
    DTYPES,
    read_safetensors,
    write_safetensors,
)
from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import BPETokenizer, MockTokenizer

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(2)


def hf_dir(tmp_path, cls="WhisperModel", alignment_heads=None, name="hf_ckpt",
           shard_size=None):
    """A random HF checkpoint on disk (d_model 64, 2 + 2 layers, the
    multilingual vocabulary), written by ``transformers``."""
    hf_cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=1500, max_target_positions=448,
    )
    torch.manual_seed(0)
    model = getattr(transformers, cls)(hf_cfg)
    path = tmp_path / name
    kw = {"max_shard_size": shard_size} if shard_size else {}
    model.save_pretrained(str(path), safe_serialization=True, **kw)
    if alignment_heads is not None:
        with open(path / "generation_config.json", "w") as f:
            json.dump({"alignment_heads": alignment_heads}, f)
    return str(path)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_states_equal(got: dict, ref: dict) -> None:
    assert set(got) == set(ref), set(got) ^ set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        assert torch.equal(_bits(got[key]), _bits(ref[key])), key


def _jax_reference(path: str, dtype) -> dict:
    _, tree = W.load_checkpoint_dir(path, dtype)
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("cls", ["WhisperModel", "WhisperForConditionalGeneration"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_equals_jax_loader(tmp_path, dtype, cls):
    path = hf_dir(tmp_path, cls)
    if cls == "WhisperForConditionalGeneration":
        keys = read_safetensors(os.path.join(path, "model.safetensors"))
        assert all(k.startswith("model.") or k == "proj_out.weight" for k in keys)
    cfg, state = L.load_checkpoint_dir(path, getattr(torch, dtype))
    assert (cfg.n_audio_state, cfg.n_text_layer, cfg.n_vocab) == (64, 2, 51865)
    _assert_states_equal(state, _jax_reference(path, getattr(jnp, dtype)))
    # the fused key bias is zero, as the JAX package's fuse_qkv makes it
    assert not state["decoder.blocks.1.attn.qkv.bias"][64:128].any()


def test_multi_file_directory(tmp_path):
    """Shards written by ``transformers`` and two files of the port's writer
    load as the single file does."""
    whole = L.load_checkpoint_dir(hf_dir(tmp_path), torch.float32)[1]
    sharded = hf_dir(tmp_path, name="sharded", shard_size="2MB")
    assert len([f for f in os.listdir(sharded) if f.endswith(".safetensors")]) > 1
    _assert_states_equal(L.load_checkpoint_dir(sharded, torch.float32)[1], whole)
    split = tmp_path / "split"
    split.mkdir()
    sd = read_safetensors(os.path.join(hf_dir(tmp_path, name="one"), "model.safetensors"))
    names = sorted(sd)
    write_safetensors(str(split / "a.safetensors"), {k: sd[k] for k in names[::2]})
    write_safetensors(str(split / "b.safetensors"), {k: sd[k] for k in names[1::2]})
    with open(os.path.join(sharded, "config.json")) as f, open(split / "config.json", "w") as g:
        g.write(f.read())
    _assert_states_equal(L.load_checkpoint_dir(str(split), torch.float32)[1], whole)
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        L.read_checkpoint_dir(str(tmp_path))


@pytest.mark.parametrize("fmt", sorted(DTYPES))
def test_safetensors_io_against_the_package(tmp_path, fmt):
    dtype = DTYPES[fmt]
    g = torch.Generator().manual_seed(7)
    if dtype.is_floating_point:
        tensors = {"w": torch.randn(5, 3, generator=g).to(dtype),
                   "v": torch.randn(7, generator=g).to(dtype)}
    else:
        lo, hi = (0, 255) if dtype == torch.uint8 else (-100, 100)
        tensors = {"w": torch.randint(lo, hi, (5, 3), generator=g, dtype=dtype),
                   "v": torch.randint(lo, hi, (7,), generator=g, dtype=dtype)}
    tensors["odd"] = torch.ones(3, dtype=torch.int8)  # 3 bytes: misaligns what follows it
    tensors["empty"] = torch.zeros(0, 4, dtype=dtype)
    ours = str(tmp_path / "ours.safetensors")
    write_safetensors(ours, tensors)
    _assert_states_equal(safetensors_torch.load_file(ours), tensors)
    theirs = str(tmp_path / "theirs.safetensors")
    safetensors_torch.save_file(tensors, theirs)
    _assert_states_equal(read_safetensors(theirs), tensors)


def test_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    safetensors_torch.save_file({"x": torch.zeros(2, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        read_safetensors(path)


def test_asr_loads_alignment_heads_and_tokenizer(tmp_path):
    from realtime_whisper_asr_tpu.models.whisper.bpe import write_vocab_files
    from tests.test_tokenizer import byte_vocab_with_merges

    path = hf_dir(tmp_path, alignment_heads=[[1, 0], [1, 1]])
    asr = TorchWhisperASR(checkpoint_dir=path, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(asr.alignment_heads, [[0.0, 0.0], [1.0, 1.0]])
    assert isinstance(asr.tokenizer, MockTokenizer)
    _assert_states_equal(asr.model.state_dict(), _jax_reference(path, jnp.float32))
    write_vocab_files(path, *byte_vocab_with_merges())
    asr = TorchWhisperASR(checkpoint_dir=path, dtype=torch.float32, device="cpu")
    assert isinstance(asr.tokenizer, BPETokenizer)
    assert asr.tokenizer.encode(" hello") == [260]
    segs = asr.transcribe(np.random.default_rng(0).standard_normal(32000).astype(np.float32)
                          * 0.1)
    assert isinstance(segs.tokens, list)


def test_directory_without_tokenizer_files_gives_the_mock(tmp_path, monkeypatch):
    """A checkpoint directory with no tokenizer file gives the mock
    tokenizer even where transformers would build one from nothing (as one
    installation did on the card's machine, so the golden ``prequant`` row's
    text came out empty)."""
    from realtime_whisper_asr_tpu_torch.models.whisper import tokenizer as T

    monkeypatch.setattr(T.HFTokenizer, "from_dir", classmethod(lambda cls, path, cfg: "hf"))
    cfg = L.config_from_hf(json.load(open(os.path.join(hf_dir(tmp_path), "config.json"))))
    assert isinstance(T.get_tokenizer(cfg, str(tmp_path / "hf_ckpt")), MockTokenizer)
    with open(tmp_path / "hf_ckpt" / "tokenizer_config.json", "w") as f:
        f.write("{}")
    assert T.get_tokenizer(cfg, str(tmp_path / "hf_ckpt")) == "hf"


@pytest.mark.parametrize("content", ["{not json", '{"alignment_heads": [[9, 9]]}',
                                     '{"alignment_heads": 3}', "[]"],
                         ids=["malformed", "out-of-range", "not-pairs", "not-an-object"])
def test_alignment_heads_malformed_is_none(tmp_path, content):
    path = hf_dir(tmp_path)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        f.write(content)
    asr = TorchWhisperASR(checkpoint_dir=path, dtype=torch.float32, device="cpu")
    assert asr.alignment_heads is None
