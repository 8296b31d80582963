"""HF-layout Whisper checkpoints -> the port's state dict.

Port of ``realtime_whisper_asr_tpu/models/whisper/load.py``. A local
directory in the HuggingFace layout (``config.json`` + ``*.safetensors``) is
read with the port's own safetensors reader (``safetensors_io``: a memory
map, no ``safetensors`` or ``transformers`` package) and mapped straight to
the state dict of ``model.Whisper``: HF's torch layouts ((out, in) linears,
(out, in, k) convolutions) are the port's, so nothing is transposed; the
self-attention projections are fused into ``attn.qkv`` along the output
dim with a zero key bias, as the JAX package's ``quant.fuse_qkv`` fuses them
(``convert._fused_qkv``). Every float is cast to ``dtype`` before the fuse,
as the JAX loader casts before its ASR fuses and quantizes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.safetensors_io import read_safetensors


def config_from_hf(hf_cfg: Mapping[str, Any], name: str = "hf") -> WhisperConfig:
    """The architecture of an HF ``config.json``."""
    return WhisperConfig(
        name=name,
        n_mels=hf_cfg["num_mel_bins"],
        n_audio_ctx=hf_cfg.get("max_source_positions", 1500),
        n_audio_state=hf_cfg["d_model"],
        n_audio_head=hf_cfg["encoder_attention_heads"],
        n_audio_layer=hf_cfg["encoder_layers"],
        n_vocab=hf_cfg["vocab_size"],
        n_text_ctx=hf_cfg.get("max_target_positions", 448),
        n_text_state=hf_cfg["d_model"],
        n_text_head=hf_cfg["decoder_attention_heads"],
        n_text_layer=hf_cfg["decoder_layers"],
    )


def _block(get, state: dict, dst: str, src: str, cross: bool) -> None:
    """One HF encoder or decoder layer ``src`` into the port's block ``dst``
    (a layer norm's weight and bias map as a linear's do)."""

    def linear(name: str, key: str, bias: bool = True) -> None:
        state[f"{dst}.{name}.weight"] = get(f"{src}.{key}.weight")
        if bias:
            state[f"{dst}.{name}.bias"] = get(f"{src}.{key}.bias")

    norm = linear

    a = f"{src}.self_attn"
    bq = get(f"{a}.q_proj.bias")
    state[f"{dst}.attn.qkv.weight"] = torch.cat(
        [get(f"{a}.{p}_proj.weight") for p in ("q", "k", "v")], dim=0)
    state[f"{dst}.attn.qkv.bias"] = torch.cat(
        [bq, torch.zeros_like(bq), get(f"{a}.v_proj.bias")], dim=0)
    norm("attn_ln", "self_attn_layer_norm")
    linear("attn.out", "self_attn.out_proj")
    norm("mlp_ln", "final_layer_norm")
    linear("fc1", "fc1")
    linear("fc2", "fc2")
    if cross:
        norm("cross_ln", "encoder_attn_layer_norm")
        linear("cross.query", "encoder_attn.q_proj")
        linear("cross.key", "encoder_attn.k_proj", bias=False)
        linear("cross.value", "encoder_attn.v_proj")
        linear("cross.out", "encoder_attn.out_proj")


def params_from_hf_state_dict(sd: Mapping[str, Any], cfg: WhisperConfig,
                              dtype=torch.float32) -> dict[str, torch.Tensor]:
    """An HF ``WhisperModel`` / ``WhisperForConditionalGeneration`` state
    dict (torch tensors or numpy arrays) -> the port's state dict, CPU
    tensors in ``dtype``. Tolerates the ``model.`` prefix and ignores the
    tied ``proj_out.weight``, as the JAX loader."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def get(key: str) -> torch.Tensor:
        v = sd[key]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        return t.to(dtype)

    state: dict[str, torch.Tensor] = {}
    for conv in ("conv1", "conv2"):
        state[f"encoder.{conv}.weight"] = get(f"encoder.{conv}.weight")
        state[f"encoder.{conv}.bias"] = get(f"encoder.{conv}.bias")
    state["encoder.pos_emb"] = get("encoder.embed_positions.weight")
    for i in range(cfg.n_audio_layer):
        _block(get, state, f"encoder.blocks.{i}", f"encoder.layers.{i}", False)
    state["encoder.ln_post.weight"] = get("encoder.layer_norm.weight")
    state["encoder.ln_post.bias"] = get("encoder.layer_norm.bias")
    state["decoder.tok_emb"] = get("decoder.embed_tokens.weight")
    state["decoder.pos_emb"] = get("decoder.embed_positions.weight")
    for i in range(cfg.n_text_layer):
        _block(get, state, f"decoder.blocks.{i}", f"decoder.layers.{i}", True)
    state["decoder.ln.weight"] = get("decoder.layer_norm.weight")
    state["decoder.ln.bias"] = get("decoder.layer_norm.bias")
    return state


def read_checkpoint_dir(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of every ``*.safetensors`` file under ``path``, the files
    in sorted order (a later file's tensor of the same name wins), each a
    view of the file's memory map."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    sd: dict[str, torch.Tensor] = {}
    for fname in files:
        sd.update(read_safetensors(os.path.join(path, fname)))
    return sd


def load_checkpoint_dir(path: str, dtype=torch.bfloat16) -> tuple[WhisperConfig, dict]:
    """Load an HF-layout local directory (``config.json`` + ``*.safetensors``)
    -> (config, the port's state dict in ``dtype``)."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, name=os.path.basename(os.path.normpath(path)))
    return cfg, params_from_hf_state_dict(read_checkpoint_dir(path), cfg, dtype)
