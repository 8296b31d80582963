"""Int8 / int4 weight-only quantization tiers over the port's state dict.

Port of ``realtime_whisper_asr_tpu/models/whisper/quant.py``. Each function
gives, bit for bit, the ``q`` and ``s`` the JAX package's gives on the same
f32 weights, on the card too: the same IEEE division (by a tensor,
``device_constant``), round-half-even, clip, 1e-12 scale floor and absmax
over the same (input) axis. The port keeps torch's (out, in) layout
for dense and int8 linears, so

- an int8 linear ``name`` becomes ``name.q`` int8 (out, in) — the JAX ``q``
  transposed — and ``name.s`` f32 (out,) per-output-column scales;
- an int4 linear becomes ``name.q`` int8 (in/2, out), nibble-packed along the
  input dim exactly as the JAX package packs it (even input row in the low
  nibble, odd in the high), and ``name.s`` f32 (G, out) per group of
  ``INT4_GROUP`` input rows; the packed-int4 kernel (``ops/int4_matmul.py``)
  reads that layout as it is;
- the tied token embedding becomes ``decoder.tok_emb.q`` int8 (V, d) and
  ``decoder.tok_emb.s`` f32 (V,) per vocabulary row.

Per-column scales make quantizing the fused qkv weight the same as fusing
the quantized q/k/v parts (int4 groups partition the shared input dim), so
quantizing the port's fused ``attn.qkv`` gives what ``fuse_qkv(quantize_*)``
gives. The tiers quantize every block linear the JAX package's
``_LINEAR_KEYS`` names: self-attention qkv and out, cross-attention query,
key, value and out, fc1 and fc2.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from realtime_whisper_asr_tpu_torch.ops.int8_matmul import device_constant

#: int4 scale-group size along the input dim
INT4_GROUP = 128

#: tier -> (encoder blocks, decoder blocks, int8 tied head); the ASR
#: backend's ``quantization=`` values. ``"int8-kv"`` has ``"int8-all"``'s
#: weights and adds int8 KV caches (``model.Whisper.kv_quant``)
TIERS = {
    None: (None, None, False),
    "int8": (None, "int8", False),
    "int8-all": ("int8", "int8", True),
    "int8-kv": ("int8", "int8", True),
    "int4": (None, "int4", True),
    "int4-all": ("int8", "int4", True),
}

#: how far a tier quantizes, the JAX backend's rank table: a pre-quantized
#: checkpoint runs a requested tier only if the tier ranks at least as high
#: (its dense weights are gone, so it cannot be weakened)
RANK = {"int8": 1, "int8-all": 2, "int8-kv": 2, "int4": 3, "int4-all": 4}

_BLOCK_LINEAR = re.compile(
    r"^(encoder|decoder)\.blocks\.\d+\."
    r"(attn\.qkv|attn\.out|cross\.query|cross\.key|cross\.value|cross\.out|fc1|fc2)\.weight$")


def tier_layout(quantization: Optional[str]) -> tuple[Optional[str], Optional[str], bool]:
    """(encoder kind, decoder kind, int8 head) of a tier; an unknown value
    raises ``ValueError``."""
    if quantization in ("", "none"):
        quantization = None
    if quantization not in TIERS:
        raise ValueError(f"unknown quantization {quantization!r}")
    return TIERS[quantization]


# ------------------------------------------------------------ weight level


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (q int8 (out, in), s f32 (out,)) with absmax
    scales over the input dim (the JAX package's per-column scales)."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=1) / device_constant(127.0, w32.device), min=1e-12)
    q = torch.clamp(torch.round(w32 / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], (in, out) -> nibble-packed int8 (in/2, out):
    byte = (q[2i] & 0xF) | (q[2i+1] << 4)."""
    q32 = q.to(torch.int32)
    return ((q32[0::2] & 0xF) | (q32[1::2] << 4)).to(torch.int8).contiguous()


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: (in/2, out) packed -> (in, out) int8, the
    low nibble sign-extended by shifts, the high one by an arithmetic
    shift."""
    p32 = p.to(torch.int32)
    lo = (p32 << 28) >> 28
    hi = p32 >> 4
    return torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1]).to(torch.int8)


def int4_groups(din: int, group: int = INT4_GROUP) -> int:
    """Scale groups along an input dim of ``din`` (one if indivisible)."""
    return din // group if (din % group == 0 and din >= group) else 1


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) f32 weight -> (packed q int8 (in/2, out), s f32 (G, out))
    with absmax scales over each group of ``group`` input rows."""
    w32 = w.float()
    dout, din = w32.shape
    g = int4_groups(din, group)
    wg = w32.reshape(dout, g, din // g)
    s = torch.clamp(wg.abs().amax(dim=2) / device_constant(7.0, w32.device), min=1e-12)
    q = torch.clamp(torch.round(wg / s[:, :, None]), -7, 7).to(torch.int8)
    return pack_int4(q.reshape(dout, din).t()), s.t().contiguous()


def dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dense f32 (out, in) view of an int8 (q (out, in), s (out,)) or packed
    int4 (q (in/2, out), s (G, out)) weight, the JAX package's ``_dequant``;
    int4 is told by its grouped scales (``s.ndim == q.ndim``)."""
    s = s.float()
    if s.ndim == q.ndim:
        w = unpack_int4(q).float()  # (in, out)
        g = s.shape[0]
        din, dout = w.shape
        return (w.reshape(g, din // g, dout) * s[:, None, :]).reshape(din, dout).t()
    return q.float() * s[:, None]


# ------------------------------------------------------------- state level


def _quantize_blocks(state: dict, part: str, kind: str) -> dict:
    """The block linears of ``part`` to ``kind``. Idempotent, as the JAX
    package's tier transforms: a linear already in ``kind`` stays as it is;
    int4 takes an int8 linear through its dequantized f32 weight, as the JAX
    package's ``_quantize_weight_int4`` does; int8 leaves a quantized linear
    as it is (the JAX ``_quantize_tree`` skips ``{"q", "s"}`` leaves)."""
    out = {}
    for key, w in state.items():
        stem = key[:-2] + ".weight" if key.endswith((".q", ".s")) else key
        m = _BLOCK_LINEAR.match(stem)
        if m is None or m.group(1) != part:
            out[key] = w
            continue
        if key.endswith(".s"):  # written with its q below
            continue
        if key.endswith(".weight"):
            name = key[: -len(".weight")]
            quantize_weight = quantize_int4 if kind == "int4" else quantize_int8
            out[f"{name}.q"], out[f"{name}.s"] = quantize_weight(w)
            continue
        name = key[: -len(".q")]
        s = state[f"{name}.s"]
        if kind == "int4" and s.ndim != w.ndim:  # int8 -> int4
            out[f"{name}.q"], out[f"{name}.s"] = quantize_int4(dequant(w, s))
        else:
            out[f"{name}.q"], out[f"{name}.s"] = w, s
    return out


def quantize_decoder(state: dict) -> dict:
    """Decoder block linears to int8 (the ``"int8"`` tier)."""
    return _quantize_blocks(state, "decoder", "int8")


def quantize_logits_head(state: dict) -> dict:
    """The tied ``tok_emb`` to int8 with per-vocabulary-row scales (as it
    is when it is int8 already)."""
    if "decoder.tok_emb" not in state:
        return dict(state)
    out = {k: v for k, v in state.items() if k != "decoder.tok_emb"}
    out["decoder.tok_emb.q"], out["decoder.tok_emb.s"] = quantize_int8(state["decoder.tok_emb"])
    return out


def quantize_all(state: dict) -> dict:
    """Encoder and decoder block linears plus the tied head to int8 (the
    ``"int8-all"`` tier)."""
    return quantize_logits_head(_quantize_blocks(quantize_decoder(state), "encoder", "int8"))


def quantize_decoder_int4(state: dict) -> dict:
    """Decoder block linears to int4-g128 and the tied head to int8 (the
    ``"int4"`` tier)."""
    return quantize_logits_head(_quantize_blocks(state, "decoder", "int4"))


def quantize_all_int4(state: dict) -> dict:
    """int4-g128 decoder blocks, int8 encoder blocks and int8 head (the
    ``"int4-all"`` tier)."""
    return _quantize_blocks(quantize_decoder_int4(state), "encoder", "int8")


def quantize(state: dict, quantization: Optional[str]) -> dict:
    """The tier's transform of a state dict (identity for None), dense or
    quantized already: each transform is idempotent, so a tier applied to
    its own output gives that output again."""
    tier_layout(quantization)
    fn = {"int8": quantize_decoder, "int8-all": quantize_all, "int8-kv": quantize_all,
          "int4": quantize_decoder_int4, "int4-all": quantize_all_int4}.get(quantization or None)
    return fn(state) if fn else dict(state)


def _block_kind(state: dict, part: str) -> Optional[str]:
    """The kind of the first quantized block linear of ``part`` in the state
    dict's order (int4 by its grouped scales), or None."""
    for key, q in state.items():
        if key.startswith(f"{part}.blocks.") and key.endswith(".q"):
            return "int4" if state[key[:-1] + "s"].ndim == q.ndim else "int8"
    return None


def detect_quantization(state: dict) -> Optional[str]:
    """``"int8"``, ``"int8-all"``, ``"int4"`` or ``"int4-all"`` when the
    state dict carries pre-quantized block linears (a checkpoint saved after
    a tier's transform), else None: the JAX package's
    ``detect_quantization`` on the same weights. The decoder's blocks name
    the kind; a quantized encoder block adds ``-all``."""
    dec = _block_kind(state, "decoder")
    if dec is None:
        return None
    return dec + ("-all" if _block_kind(state, "encoder") is not None else "")
