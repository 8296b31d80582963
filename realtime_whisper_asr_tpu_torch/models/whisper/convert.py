"""Weights carried across from the JAX package.

The JAX package keeps its params as a pytree with the layers stacked along a
leading axis, linear weights as (in, out), conv weights as (k, in, out), and
the self-attention projections either separate (``wq|wk|wv``) or fused
(``wqkv``). ``params_from_jax`` turns that tree (numpy leaves) into the state
dict of ``model.Whisper``: one entry per block, torch's (out, in) and
(out, in, k) layouts, and the self-attention projections fused the way the
JAX package's ``quant.fuse_qkv`` fuses them (key bias zero), which its ASR
backend always applies.

Quantized leaves (``{"q", "s"}`` dicts from the JAX package's ``quant``
tiers) carry across unchanged in value: an int8 linear becomes ``name.q``
(out, in) — the JAX ``q`` transposed — and ``name.s``; a packed int4 linear
(grouped scales, ``s.ndim == q.ndim``) keeps the JAX layout, ``name.q``
(in/2, out) and ``name.s`` (G, out), which the port's int4 kernel reads; the
int8 tied embedding becomes ``decoder.tok_emb.q`` / ``.s``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot take
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _index(w, i: int):
    """Layer ``i`` of a stacked leaf, dense or a quantized dict."""
    if isinstance(w, dict):
        return {k: np.asarray(v)[i] for k, v in w.items()}
    return np.asarray(w)[i]


def _linear(state: dict, name: str, w, b) -> None:
    if isinstance(w, dict):
        q, s = np.asarray(w["q"]), np.asarray(w["s"])
        state[f"{name}.q"] = _t(q if s.ndim == q.ndim else q.T)
        state[f"{name}.s"] = _t(s)
    else:
        state[f"{name}.weight"] = _t(np.asarray(w).T)
    if b is not None:
        state[f"{name}.bias"] = _t(b)


def _norm(state: dict, name: str, node: dict) -> None:
    state[f"{name}.weight"] = _t(node["g"])
    state[f"{name}.bias"] = _t(node["b"])


def _concat_out(ws: list):
    """Concatenate weights along the output axis, as ``quant.fuse_qkv``:
    quantized q and s both along their last axis."""
    if isinstance(ws[0], dict):
        return {k: np.concatenate([np.asarray(w[k]) for w in ws], axis=-1) for k in ("q", "s")}
    return np.concatenate([np.asarray(w) for w in ws], axis=-1)


def _fused_qkv(attn: dict):
    if "wqkv" in attn:
        return attn["wqkv"], np.asarray(attn["bqkv"])
    w = _concat_out([attn[k] for k in ("wq", "wk", "wv")])
    bq = np.asarray(attn["bq"])
    return w, np.concatenate([bq, np.zeros_like(bq), np.asarray(attn["bv"])], axis=-1)


def _layer(node: dict, i: int) -> dict:
    """Layer ``i`` of a layer-stacked subtree."""
    return {k: _index(v, i) for k, v in node.items()}


def _blocks(state: dict, prefix: str, stacked: dict, cross: bool) -> None:
    n_layer = np.asarray(stacked["attn_ln"]["g"]).shape[0]
    wqkv, bqkv = _fused_qkv(stacked["attn"])
    for i in range(n_layer):
        p = f"{prefix}.{i}"
        attn, mlp = _layer(stacked["attn"], i), _layer(stacked["mlp"], i)
        _norm(state, f"{p}.attn_ln", _layer(stacked["attn_ln"], i))
        _linear(state, f"{p}.attn.qkv", _index(wqkv, i), bqkv[i])
        _linear(state, f"{p}.attn.out", attn["wo"], attn["bo"])
        _norm(state, f"{p}.mlp_ln", _layer(stacked["mlp_ln"], i))
        _linear(state, f"{p}.fc1", mlp["w1"], mlp["b1"])
        _linear(state, f"{p}.fc2", mlp["w2"], mlp["b2"])
        if cross:
            c = _layer(stacked["cross"], i)
            _norm(state, f"{p}.cross_ln", _layer(stacked["cross_ln"], i))
            _linear(state, f"{p}.cross.query", c["wq"], c["bq"])
            _linear(state, f"{p}.cross.key", c["wk"], None)
            _linear(state, f"{p}.cross.value", c["wv"], c["bv"])
            _linear(state, f"{p}.cross.out", c["wo"], c["bo"])


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX params pytree with numpy leaves -> state dict of ``model.Whisper``
    (CPU tensors in the leaves' dtype; ``load_state_dict`` casts and moves
    them to the model's)."""
    enc, dec = tree["encoder"], tree["decoder"]
    state: dict[str, torch.Tensor] = {}
    for conv in ("conv1", "conv2"):
        state[f"encoder.{conv}.weight"] = _t(np.asarray(enc[conv]["w"]).transpose(2, 1, 0))
        state[f"encoder.{conv}.bias"] = _t(enc[conv]["b"])
    state["encoder.pos_emb"] = _t(enc["pos_emb"])
    _blocks(state, "encoder.blocks", enc["blocks"], cross=False)
    _norm(state, "encoder.ln_post", enc["ln_post"])
    if isinstance(dec["tok_emb"], dict):
        state["decoder.tok_emb.q"] = _t(dec["tok_emb"]["q"])
        state["decoder.tok_emb.s"] = _t(dec["tok_emb"]["s"])
    else:
        state["decoder.tok_emb"] = _t(dec["tok_emb"])
    state["decoder.pos_emb"] = _t(dec["pos_emb"])
    _blocks(state, "decoder.blocks", dec["blocks"], cross=True)
    _norm(state, "decoder.ln", dec["ln"])
    return state


def load_flat_npz(path: str) -> dict[str, torch.Tensor]:
    """State dict from a flat npz of the JAX pytree with ``/``-joined keys
    (``"encoder/conv1/w"``, as ``tools/golden.py`` writes the golden
    fixture), leaves read as float32."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key].astype(np.float32)
    return params_from_jax(tree)
