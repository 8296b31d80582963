"""Whisper encoder-decoder in PyTorch: the dense inference path.

Port of ``realtime_whisper_asr_tpu/models/whisper/model.py`` with the same
numerics, in PyTorch idiom:

- ``nn.Module``s with an ``nn.ModuleList`` of blocks where the JAX package
  stacks the layers and runs ``lax.scan``;
- f32 islands inside a configurable compute dtype (bf16 on the card):
  layer norm, attention scores and softmax, and the logits head are computed
  in f32, as the JAX package's ``preferred_element_type=f32`` does;
- the self-attention projections are fused into one ``qkv`` linear (the JAX
  package's inference path always runs ``quant.fuse_qkv``);
- the decoder's self-attention K/V cache is written in place at the decode
  position (JAX writes a new cache array per step);
- cross-attention weights are captured through the alignment mask for DTW
  word timestamps (timestamps.py);
- the int8 / int4 tiers (``quant.py``) swap block linears for
  ``Int8Linear`` / ``Int4Linear`` and the tied embedding for
  ``Int8Embedding``, computing the JAX package's quantized ``_linear``,
  ``_emb_rows`` and ``_logits_head``;
- the ``int8-kv`` tier (``Whisper.kv_quant``) keeps both decoder caches as
  int8 rows with f32 per-row scales and attends to them with exact int32
  products (``_attend_q8``); its decoder activations are bf16 whatever the
  weights' dtype, as the JAX package's;
- beam search (``decode_step(beam_ancestry=)``): each stream's K beams keep
  their self K/V rows in one physical block of K × T positions, never
  reordered; a beam reads its ancestors' rows through a (K, K, T) ancestry
  table (``_attend_beam`` / ``_attend_beam_q8``), and the stream's cross
  K/V is read once for its K beams, folded into the query axis.

The public functions keep the JAX package's layouts: mel (B, T, n_mels),
encoder output (B, T/2, d), caches (L, B, H, T, Dh), logits f32.

Tensor parallelism (``parallel/tp.py``) subclasses ``Whisper``: the hooks
here are ``_text_heads`` (the heads this process holds) and
``_seq_scatter`` / ``_seq_gather`` around the transformer stacks of
``encode`` and ``decode_full`` (identities here), and ``activation_sharding``
is the sequence-parallel scope, the JAX package's context of that name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from realtime_whisper_asr_tpu_torch.device import no_tf32_cudnn, resolve_device
from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.quant import int4_groups, tier_layout
from realtime_whisper_asr_tpu_torch.ops.int4_matmul import int4_linear
from realtime_whisper_asr_tpu_torch.ops.int8_matmul import int8_bmm, int8_matmul, quantize_rows

_NEG = -1e9  # additive mask value (as the JAX package)
_INV_SQRT2_16 = 0.70703125  # 2**-0.5 rounded to bf16 (and to f16 alike)

#: the sequence-parallel scope (``parallel.sharding.sequence_sharding``), or None
_ACT_SHARDING = None


@contextlib.contextmanager
def activation_sharding(sharding):
    """Within this block a tensor-parallel model's ``encode`` and
    ``decode_full`` run sequence-parallel over ``sharding``'s group: the
    layer norms and residuals between the tensor-parallel linears hold
    T / tp positions of each row (the JAX package's
    ``activation_sharding``). Restored on exit."""
    global _ACT_SHARDING
    prev, _ACT_SHARDING = _ACT_SHARDING, sharding
    try:
        yield
    finally:
        _ACT_SHARDING = prev


class LayerNorm(nn.LayerNorm):
    """Layer norm computed in f32 and cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU. At f32 torch's; at a 16-bit dtype the JAX package's
    evaluation (``jax.nn.gelu(approximate=False)``), op by op in that dtype:
    ``0.5·x · erfc(−x · 2^-½)`` with the constant rounded to the dtype."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (x * 0.5) * torch.special.erfc(-x * _INV_SQRT2_16)


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``_linear`` rounding: at a 16-bit dtype the product
    is rounded to the dtype, then the bias is added in it (the fused call
    would add it before its one rounding). At f32 the fused call."""
    if x.dtype == torch.float32 or bias is None:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


class Linear(nn.Linear):
    """Dense linear that rounds where the JAX package's ``_linear`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight, self.bias)


class Conv1d(nn.Conv1d):
    """Convolution that rounds as the JAX package's conv stem: at a 16-bit
    dtype the bias is added after the rounded product; at f32 the fused
    call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None]


class _QuantLinear(nn.Module):
    """Weight-only quantized linear's buffers: ``q`` (int8), ``s`` (f32
    scales) and a bias in the compute dtype. The activations are quantized
    per row on each call, as the JAX package's ``_linear``; ``compiled``
    selects ``quantize_rows``'s compiled scale (the ``int8-kv`` tier)."""

    compiled = False

    def __init__(self, d_in: int, d_out: int, q_shape, s_shape, bias: bool = True,
                 dtype=None, device=None):
        super().__init__()
        self.in_features, self.out_features = d_in, d_out
        self.register_buffer("q", torch.empty(q_shape, dtype=torch.int8, device=device))
        self.register_buffer("s", torch.empty(s_shape, dtype=torch.float32, device=device))
        if bias:
            self.bias = nn.Parameter(torch.empty(d_out, dtype=dtype, device=device))
        else:
            self.register_parameter("bias", None)


class Int8Linear(_QuantLinear):
    """int8 weights q (out, in) with per-output scales s (out,): x quantized
    by ``quantize_rows``, an exact int32 product, then ``y * sx * s`` in that
    order, cast to x's dtype, then ``+ bias``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=None, device=None):
        super().__init__(d_in, d_out, (d_out, d_in), (d_out,), bias, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, sx = quantize_rows(x, self.compiled)
        y = int8_matmul(xq.reshape(-1, self.in_features), self.q).float()
        y = (y * sx.reshape(-1, 1) * self.s).to(x.dtype).reshape(*x.shape[:-1], self.out_features)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Int4Linear(_QuantLinear):
    """Nibble-packed int4 weights q (in/2, out) with per-group scales s
    (G, out): the whole linear (row quantization, product, ``* sx``, cast,
    bias) is ``int4_linear``, the packed-int4 kernel family (K2) on the card
    in at most two launches, its plain version on the CPU."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=None, device=None):
        super().__init__(d_in, d_out, (d_in // 2, d_out), (int4_groups(d_in), d_out), bias,
                         dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = int4_linear(x.reshape(-1, self.in_features).contiguous(), self.q, self.s, bias)
        return y.reshape(*x.shape[:-1], self.out_features)


class Int8Embedding(nn.Module):
    """Tied token embedding as int8 rows q with per-row scales s (V,), for
    the embedding gather and the logits head. ``q`` holds V rows padded with
    zeros to a multiple of 8 (the card's int8 product takes N % 8 == 0);
    the state dict may carry the V rows alone, which load pads.
    ``compiled`` as ``_QuantLinear``'s."""

    compiled = False

    def __init__(self, n_vocab: int, d: int, device=None):
        super().__init__()
        self.n_vocab = n_vocab
        self.register_buffer("q", torch.empty(-(-n_vocab // 8) * 8, d, dtype=torch.int8,
                                              device=device))
        self.register_buffer("s", torch.empty(n_vocab, dtype=torch.float32, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        q = state_dict.get(prefix + "q")
        if q is not None and q.shape[0] == self.n_vocab < self.q.shape[0]:
            state_dict[prefix + "q"] = F.pad(q, (0, 0, 0, self.q.shape[0] - self.n_vocab))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """f32 embedding rows of ``tokens``."""
        return self.q[tokens].float() * self.s[tokens][..., None]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x @ dequant(q).T, f32: ``y * sx * s`` over an exact int32 product."""
        xq, sx = quantize_rows(x, self.compiled)
        lead = x.shape[:-1]
        y = int8_matmul(xq.reshape(-1, xq.shape[-1]), self.q)[:, : self.n_vocab]
        return y.reshape(*lead, self.n_vocab).float() * sx * self.s


def _quantize_linears(blocks: nn.ModuleList, kind: str, **factory) -> None:
    """Swap every ``nn.Linear`` of ``blocks`` for its ``kind`` counterpart."""
    cls = Int8Linear if kind == "int8" else Int4Linear
    for parent in list(blocks.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear):
                setattr(parent, name, cls(child.in_features, child.out_features,
                                          bias=child.bias is not None, **factory))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)  # (B,H,T,Dh)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attend(q, k, v, mask: Optional[torch.Tensor] = None, return_weights: bool = False):
    """q (B,H,Tq,Dh), k/v (B,H,Tk,Dh); additive f32 mask. Scores and softmax
    in f32 (a bf16 matmul would round the scores to bf16); the weights are
    cast to v's dtype for the value product, as the JAX package does."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    out = torch.matmul(w.to(v.dtype), v)
    return out, (w if return_weights else None)


def _fold_beams(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B·K, H, 1, X) per-beam rows -> (B, H, K, X): each stream's K beams
    as K query rows against the stream's own K/V."""
    bk, h, _, d = x.shape
    return x.view(bk // k, k, h, d).transpose(1, 2)


def _unfold_beams(x: torch.Tensor) -> torch.Tensor:
    """(B, H, K, X) -> (B·K, H, 1, X), the inverse of ``_fold_beams``."""
    b, h, k, d = x.shape
    return x.transpose(1, 2).reshape(b * k, h, 1, d)


def _select_ancestors(s_all: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """(B, H, K, K·T) per-physical-row values and the (B, K, K, T) 0/1
    ancestry -> (B, H, K, T): beam k's value at t from the row holding its
    position t. A sum of one term and exact zeros, as the JAX package's
    ``einsum("bjht,bjt->bht")``."""
    b, h, k, jt = s_all.shape
    return (s_all.view(b, h, k, k, jt // k) * anc[:, None]).sum(dim=3)


def _attend_beam(q, kc, vc, anc, mask):
    """Beam self-attention through the ancestry table, the JAX package's
    ``_attend_beam`` for B streams: q (B·K, H, 1, Dh) per-beam queries,
    kc/vc (B, H, K·T, Dh) the streams' physical rows (beam j's at
    j·T..j·T+T-1, never reordered), anc (B, K, K, T) with anc[b, k, j, t] = 1
    iff position t of beam k's history lives in row j, mask additive over T.
    The scores are the whole-row products against every physical row, then
    each beam's ancestors selected; the value product contracts (j, t) at
    once with the weights spread to their rows. Returns (B·K, H, 1, Dh)."""
    k = anc.shape[1]
    scale = q.shape[-1] ** -0.5
    s_all = torch.matmul(_fold_beams(q, k).float(), kc.float().transpose(-1, -2)) * scale
    w = torch.softmax(_select_ancestors(s_all, anc) + mask, dim=-1)  # (B, H, K, T)
    b, h, _, t = w.shape
    w2 = (w[:, :, :, None, :] * anc[:, None]).to(vc.dtype).reshape(b, h, k, k * t)
    return _unfold_beams(torch.matmul(w2, vc))


def _attend_beam_q8(q, k8, v8, ks, vs, anc, mask, out_dtype=torch.bfloat16):
    """int8-KV ``_attend_beam``, the JAX package's ``_attend_beam_q8``: q
    quantized per beam row, an exact int32 product against every physical
    row, ``* sq * ksᵀ * scale``, the ancestors selected, f32 softmax, the
    weights spread to their rows times the value scales, quantized per beam
    and head over all (j, t) at once, an exact int32 product, ``* sw``; every
    scale as ``quantize_rows(compiled=True)``. k8/v8 (B, H, K·T, Dh) int8,
    ks/vs (B, H, K·T, 1) f32, the rest as ``_attend_beam``."""
    k = anc.shape[1]
    scale = q.shape[-1] ** -0.5
    q8, sq = _quantize_kv_rows(_fold_beams(q, k))
    s_all = int8_bmm(q8, k8.transpose(-1, -2)).float() * sq * ks.transpose(-1, -2) * scale
    w = torch.softmax(_select_ancestors(s_all, anc) + mask, dim=-1)  # (B, H, K, T)
    b, h, _, t = w.shape
    wv = (w[:, :, :, None, :] * anc[:, None]) * vs.view(b, h, 1, k, t)
    w8, sw = _quantize_kv_rows(wv.reshape(b, h, k, k * t))
    return _unfold_beams((int8_bmm(w8, v8).float() * sw).to(out_dtype))


def _quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_quantize_kv_rows`` as its jitted decode computes
    it: (…, T, Dh) -> (int8 rows, f32 per-row scales (…, T, 1)),
    ``quantize_rows(x, compiled=True)``."""
    return quantize_rows(x, compiled=True)


def _attend_q8(q, k8, v8, ks, vs, mask: Optional[torch.Tensor] = None,
               return_weights: bool = False, out_dtype=torch.bfloat16):
    """Attention against int8 K/V rows, the JAX package's ``_attend_q8``:
    q (B,H,Tq,Dh) quantized per row, an exact int32 q8·k8ᵀ (``int8_bmm``),
    ``scores * sq * ksᵀ * scale`` in that order, f32 softmax, the per-row
    value scales folded into the weights (``w * vsᵀ``), those quantized per
    row, an exact int32 w8·v8, ``* sw``, cast to ``out_dtype``; every scale
    as the jitted reference computes it (``quantize_rows(compiled=True)``).
    K/V of batch 1 against B > 1 queries (the JAX package's shared-KV
    branch) broadcast in the products. Returns (out, f32 weights or None)."""
    scale = q.shape[-1] ** -0.5
    q8, sq = _quantize_kv_rows(q)
    scores = int8_bmm(q8, k8.transpose(-1, -2)).float() * sq * ks.transpose(-1, -2) * scale
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    w8, sw = _quantize_kv_rows(w * vs.transpose(-1, -2))
    out = (int8_bmm(w8, v8).float() * sw).to(out_dtype)
    return out, (w if return_weights else None)


class SelfAttention(nn.Module):
    def __init__(self, d: int, n_head: int, **factory):
        super().__init__()
        self.n_head = n_head
        self.qkv = Linear(d, 3 * d, **factory)  # fused wq|wk|wv, bias bq|0|bv
        self.out = Linear(d, d, **factory)

    def project(self, x: torch.Tensor):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return (_split_heads(q, self.n_head), _split_heads(k, self.n_head),
                _split_heads(v, self.n_head))


class CrossAttention(nn.Module):
    def __init__(self, d: int, n_head: int, **factory):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(d, d, **factory)
        self.key = Linear(d, d, bias=False, **factory)
        self.value = Linear(d, d, **factory)
        self.out = Linear(d, d, **factory)


class Block(nn.Module):
    """Pre-LN transformer block; decoder blocks add cross-attention."""

    def __init__(self, d: int, n_head: int, cross: bool, **factory):
        super().__init__()
        self.attn_ln = LayerNorm(d, **factory)
        self.attn = SelfAttention(d, n_head, **factory)
        if cross:
            self.cross_ln = LayerNorm(d, **factory)
            self.cross = CrossAttention(d, n_head, **factory)
        self.mlp_ln = LayerNorm(d, **factory)
        self.fc1 = Linear(d, 4 * d, **factory)
        self.fc2 = Linear(4 * d, d, **factory)

    def mha_block(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence self-attention: unmasked (the encoder's) or with an
        additive mask (the teacher-forced decoder's causal one)."""
        q, k, v = self.attn.project(self.attn_ln(x))
        o, _ = _attend(q, k, v, mask)
        return x + self.attn.out(_merge_heads(o))

    def mlp_block(self, x: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.fc1(self.mlp_ln(x)))
        return x + self.fc2(h)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positional embedding for the encoder."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, **factory):
        super().__init__()
        d = cfg.n_audio_state
        self.conv1 = Conv1d(cfg.n_mels, d, 3, padding=1, **factory)
        self.conv2 = Conv1d(d, d, 3, stride=2, padding=1, **factory)
        self.register_buffer("pos_emb", torch.empty(cfg.n_audio_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            Block(d, cfg.n_audio_head, cross=False, **factory) for _ in range(cfg.n_audio_layer))
        self.ln_post = LayerNorm(d, **factory)

    def stem(self, mel: torch.Tensor) -> torch.Tensor:
        """Conv stem (k3 s1 + k3 s2, exact GELU) + positional prefix: a
        window shorter than 30 s (the 8/16 s buckets) takes the first T/2
        rows of the positional table. Convolutions in IEEE f32 when f32."""
        with no_tf32_cudnn():
            x = _gelu(self.conv1(mel.transpose(1, 2)))
            x = _gelu(self.conv2(x)).transpose(1, 2)
        return x + self.pos_emb[: x.shape[1]].to(x.dtype)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, **factory):
        super().__init__()
        d = cfg.n_text_state
        self.tok_emb = nn.Parameter(torch.empty(cfg.n_vocab, d, **factory))
        self.pos_emb = nn.Parameter(torch.empty(cfg.n_text_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            Block(d, cfg.n_text_head, cross=True, **factory) for _ in range(cfg.n_text_layer))
        self.ln = LayerNorm(d, **factory)


@dataclasses.dataclass
class DecoderCache:
    """self_k/self_v: (L, B, H, text_ctx, Dh), written in place at the decode
    position; cross_k/cross_v: (L, B, H, audio_ctx, Dh), computed once per
    encoded window. Under ``int8-kv`` all four are int8 rows and the scale
    fields their f32 per-row scales, (L, B, H, T, 1); otherwise the scale
    fields are None. A beam search's cache holds B streams of K beams: self
    buffers (L, B, H, K·text_ctx, Dh), one block of K rows a stream
    (``Whisper.decode_step``'s ``beam_ancestry``), cross at batch B."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    self_ks: Optional[torch.Tensor] = None
    self_vs: Optional[torch.Tensor] = None
    cross_ks: Optional[torch.Tensor] = None
    cross_vs: Optional[torch.Tensor] = None

    @property
    def kv_quant(self) -> bool:
        return self.self_ks is not None

    @property
    def act_dtype(self) -> torch.dtype:
        """The decoder's activation dtype: bf16 under ``int8-kv`` (the JAX
        package's ``jnp.bfloat16 if kvq``), else the cache's."""
        return torch.bfloat16 if self.kv_quant else self.self_k.dtype

    def self_buffers(self) -> tuple:
        """The buffers a decode position writes: self K/V (and their scales)."""
        if self.kv_quant:
            return self.self_k, self.self_v, self.self_ks, self.self_vs
        return self.self_k, self.self_v


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype=torch.float32, device=None,
                 quantization: Optional[str] = None):
        """``quantization``: a tier of ``quant.TIERS``; its block linears and
        tied head take the quantized modules, whose buffers the tier's state
        dict (``quant.quantize``) fills."""
        super().__init__()
        self.cfg = cfg
        self.quantization = quantization
        #: ``int8-kv``: int8 decoder caches (``DecoderCache``), bf16 decoder
        #: activations
        self.kv_quant = quantization == "int8-kv"
        enc_kind, dec_kind, head_int8 = tier_layout(quantization)
        factory = {"dtype": dtype, "device": device}
        self.encoder = AudioEncoder(cfg, **factory)
        self.decoder = TextDecoder(cfg, **factory)
        if enc_kind:
            _quantize_linears(self.encoder.blocks, enc_kind, **factory)
        if dec_kind:
            _quantize_linears(self.decoder.blocks, dec_kind, **factory)
        if head_int8:
            del self.decoder.tok_emb
            self.decoder.tok_emb = Int8Embedding(cfg.n_vocab, cfg.n_text_state, device=device)
        if self.kv_quant:  # the tier's every quantizer as the jitted reference's
            for mod in self.modules():
                if isinstance(mod, (_QuantLinear, Int8Embedding)):
                    mod.compiled = True

    @classmethod
    def empty(cls, cfg: WhisperConfig, dtype, device,
              quantization: Optional[str] = None) -> "Whisper":
        """Uninitialised model on ``device`` (no default init is run)."""
        return cls(cfg, dtype, device="meta", quantization=quantization).to_empty(
            device=device).requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.pos_emb.dtype

    @property
    def _text_heads(self) -> int:
        """The decoder heads this model computes (and its caches hold)."""
        return self.cfg.n_text_head

    def _seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Enter a transformer stack: x (B, T, d) as the blocks carry it."""
        return x

    def _seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Leave a transformer stack: the blocks' carry as (B, T, d)."""
        return x

    def _emb_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.decoder.tok_emb
        return emb.rows(tokens) if isinstance(emb, Int8Embedding) else emb[tokens]

    # ------------------------------------------------------------- encoder

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) -> (B, T//2, d), T ≤ 2*n_audio_ctx."""
        x = self._seq_scatter(self.encoder.stem(mel))
        for blk in self.encoder.blocks:
            x = blk.mlp_block(blk.mha_block(x))
        return self.encoder.ln_post(self._seq_gather(x))

    # ------------------------------------------------------------- decoder

    def precompute_cross_kv(self, xa: torch.Tensor, out=None):
        """xa (B, audio_ctx, d) -> cross K/V, each (L, B, H, audio_ctx, Dh),
        written into ``out`` (a (K, V) pair of such buffers) when given. K/V
        come from the raw encoder output (cross_ln only normalizes the
        query)."""
        cfg, n_head = self.cfg, self._text_heads
        shape = (cfg.n_text_layer, xa.shape[0], n_head, xa.shape[1],
                 cfg.n_text_state // cfg.n_text_head)
        ck, cv = out if out is not None else (
            torch.empty(shape, dtype=xa.dtype, device=xa.device) for _ in range(2))
        for layer, blk in enumerate(self.decoder.blocks):
            ck[layer] = _split_heads(blk.cross.key(xa), n_head)
            cv[layer] = _split_heads(blk.cross.value(xa), n_head)
        return ck, cv

    def _precompute_cross_kv_q8(self, xa: torch.Tensor, out) -> None:
        """``int8-kv``'s cross K/V into ``out`` = (k8, ks, v8, vs): each
        layer's K/V quantized per row as soon as it is computed, so at most
        one layer's K/V in xa's dtype is ever live (the JAX package's
        per-layer ``_precompute_cross_kv_q8``)."""
        n_head = self._text_heads
        k8, ks, v8, vs = out
        for layer, blk in enumerate(self.decoder.blocks):
            for q_buf, s_buf, lin in ((k8, ks, blk.cross.key), (v8, vs, blk.cross.value)):
                q_buf[layer], s_buf[layer] = _quantize_kv_rows(_split_heads(lin(xa), n_head))

    def empty_cache(self, batch: int, audio_ctx: int, text_ctx: int, dtype, device,
                    kv_quant: Optional[bool] = None) -> DecoderCache:
        """Cache buffers, uninitialised (``fill_cache`` fills them): in
        ``dtype``, or int8 rows and f32 per-row scales under ``kv_quant``
        (the model's ``int8-kv`` tier when None)."""
        cfg = self.cfg
        kv_quant = self.kv_quant if kv_quant is None else kv_quant
        dh = cfg.n_text_state // cfg.n_text_head
        self_shape = (cfg.n_text_layer, batch, self._text_heads, text_ctx, dh)
        cross_shape = (cfg.n_text_layer, batch, self._text_heads, audio_ctx, dh)
        shapes = (self_shape, self_shape, cross_shape, cross_shape)
        if not kv_quant:
            return DecoderCache(*(torch.empty(shape, dtype=dtype, device=device)
                                  for shape in shapes))
        return DecoderCache(
            *(torch.empty(shape, dtype=torch.int8, device=device) for shape in shapes),
            *(torch.empty(shape[:-1] + (1,), dtype=torch.float32, device=device)
              for shape in shapes))

    def fill_cache(self, xa: torch.Tensor, cache: DecoderCache) -> None:
        """One window's cache, in place: its cross K/V written into the
        buffers, the self K/V zeroed (buffers whose addresses a captured
        decode loop keeps); under ``int8-kv`` the self scales reset to
        1e-12, as the JAX package's ``init_cache``."""
        if cache.kv_quant:
            self._precompute_cross_kv_q8(
                xa, out=(cache.cross_k, cache.cross_ks, cache.cross_v, cache.cross_vs))
            cache.self_ks.fill_(1e-12)
            cache.self_vs.fill_(1e-12)
        else:
            self.precompute_cross_kv(xa, out=(cache.cross_k, cache.cross_v))
        cache.self_k.zero_()
        cache.self_v.zero_()

    def init_cache(self, xa: torch.Tensor, text_ctx: Optional[int] = None,
                   kv_quant: Optional[bool] = None) -> DecoderCache:
        """A new cache for xa. ``text_ctx`` trims the self-attention cache
        below n_text_ctx when the caller knows its decode budget;
        ``kv_quant`` as ``empty_cache``."""
        cache = self.empty_cache(xa.shape[0], xa.shape[1], text_ctx or self.cfg.n_text_ctx,
                                 xa.dtype, xa.device, kv_quant)
        self.fill_cache(xa, cache)
        return cache

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head, f32 logits (x @ tok_emb.T with f32 products and
        sums, as the JAX package's preferred_element_type=f32); the int8 head
        of the quantized tiers through ``Int8Embedding.logits``."""
        emb = self.decoder.tok_emb
        if isinstance(emb, Int8Embedding):
            return emb.logits(x)
        return torch.matmul(x.float(), emb.float().t())

    def _decoder_layers(self, x, pos: torch.Tensor, mask, cache: DecoderCache,
                        alignment_mask: Optional[torch.Tensor], anc: Optional[torch.Tensor] = None):
        """Run the decoder blocks over x (B, S, d) at the positions ``pos``
        (S,) long, on the cache's device, writing their K/V into the self
        cache in place (int8 rows and their scales under ``int8-kv``).
        With ``anc`` (B, K, K, T), the B·K rows of x (S = 1) are K beams of
        each of B streams: beam k writes at k·T + pos of its stream's
        physical block and attends through the ancestry table, and the
        cross-attention reads each stream's K/V once for its K beams.
        Returns (hidden, xattn (B, S, audio_ctx) or None)."""
        capture = alignment_mask is not None
        kvq = cache.kv_quant
        beams = 1 if anc is None else anc.shape[1]
        if anc is not None:  # beam j's slot for this position in each block
            pos = torch.arange(beams, device=pos.device) * anc.shape[-1] + pos
        xattn = None
        for layer, blk in enumerate(self.decoder.blocks):
            q, k, v = blk.attn.project(blk.attn_ln(x))  # each (B,H,S,Dh)
            if kvq:
                (k8, ksc), (v8, vsc) = _quantize_kv_rows(k), _quantize_kv_rows(v)
                rows = (k8, v8, ksc, vsc)  # the order of self_buffers
            else:
                rows = (k, v)
            for buf, new in zip(cache.self_buffers(), rows):
                buf[layer].index_copy_(2, pos, new if anc is None else _fold_beams(new, beams))
            kc, vc, *scales = (buf[layer] for buf in cache.self_buffers())
            if anc is not None and kvq:
                o = _attend_beam_q8(q, kc, vc, *scales, anc, mask, out_dtype=x.dtype)
            elif anc is not None:
                o = _attend_beam(q, kc, vc, anc, mask)
            elif kvq:
                o, _ = _attend_q8(q, kc, vc, *scales, mask, out_dtype=x.dtype)
            else:
                o, _ = _attend(q, kc, vc, mask)
            x = x + blk.attn.out(_merge_heads(o))
            q = _split_heads(blk.cross.query(blk.cross_ln(x)), blk.cross.n_head)
            if anc is not None:
                q = _fold_beams(q, beams)
            if kvq:
                o, w = _attend_q8(q, cache.cross_k[layer], cache.cross_v[layer],
                                  cache.cross_ks[layer], cache.cross_vs[layer], None,
                                  return_weights=capture, out_dtype=x.dtype)
            else:
                o, w = _attend(q, cache.cross_k[layer], cache.cross_v[layer], None,
                               return_weights=capture)
            if anc is not None:
                o, w = _unfold_beams(o), (None if w is None else _unfold_beams(w))
            x = x + blk.cross.out(_merge_heads(o))
            x = blk.mlp_block(x)
            if capture:  # alignment-head-weighted average of (B,H,S,T) weights
                xl = torch.einsum("bhst,h->bst", w, alignment_mask[layer])
                xattn = xl if xattn is None else xattn + xl
        return self.decoder.ln(x), xattn

    def decode_span(self, tokens: torch.Tensor, pos0: int, cache: DecoderCache,
                    alignment_mask: Optional[torch.Tensor] = None):
        """Process S tokens at once (prompt/prefix/draft prefill), writing the
        KV cache. tokens (B, S) at positions pos0.. -> (logits (B, S, V) f32,
        xattn (B, S, audio_ctx) f32 or None). ``alignment_mask`` (L, H)."""
        dec = self.decoder
        s = tokens.shape[1]
        pos = pos0 + torch.arange(s, device=tokens.device)
        x = (self._emb_rows(tokens) + dec.pos_emb[pos]).to(cache.act_dtype)
        # query q may attend to cache key j iff j <= pos0 + q
        j = torch.arange(cache.self_k.shape[3], device=tokens.device)
        mask = torch.where(j[None, :] > pos[:, None], _NEG, 0.0)[None, None]
        x, xattn = self._decoder_layers(x, pos, mask, cache, alignment_mask)
        return self.logits(x), xattn

    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, cache: DecoderCache,
                    alignment_mask: Optional[torch.Tensor] = None,
                    beam_ancestry: Optional[torch.Tensor] = None):
        """One incremental step: tokens (B,) at position ``pos``, a 0-d long
        tensor on the model's device (no host value, so a CUDA graph can
        capture the step) -> (logits (B, V) f32, xattn (B, audio_ctx) f32 or
        None).

        ``beam_ancestry`` (S, K, K, T) f32 0/1: the B = S·K rows are the K
        beams of S streams, and the cache's self buffers hold each stream's
        beams as one block of K·T positions ((L, S, H, K·T, Dh)) with its
        cross K/V at batch S; beam k's position-t K/V lives in the block's
        row j where anc[s, k, j, t] = 1 (``_attend_beam``). Each beam writes
        its own row at ``pos``; nothing is reordered."""
        dec = self.decoder
        pos = pos.view(1)
        x = (self._emb_rows(tokens) + dec.pos_emb.index_select(0, pos))[:, None, :]
        t_ctx = cache.self_k.shape[3] // (1 if beam_ancestry is None else beam_ancestry.shape[1])
        j = torch.arange(t_ctx, device=tokens.device)
        mask = torch.where(j > pos, _NEG, 0.0)
        x, xattn = self._decoder_layers(x.to(cache.act_dtype), pos, mask, cache,
                                        alignment_mask, beam_ancestry)
        return self.logits(x[:, 0]), (None if xattn is None else xattn[:, 0])

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The training forward: ``decode_full`` of ``tokens`` (B, T) over
        ``encode(mel)`` -> logits (B, T, V) f32 (``train.train_step``)."""
        return self.decode_full(tokens, self.encode(mel))

    def decode_full(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder, the JAX package's ``decode_full``: tokens
        (B, T) from position 0, xa (B, audio_ctx, d) -> logits (B, T, V) f32,
        every position at once (causal self-attention, no cache)."""
        dec = self.decoder
        t = tokens.shape[1]
        x = (self._emb_rows(tokens) + dec.pos_emb[:t]).to(xa.dtype)
        causal = torch.triu(torch.full((t, t), _NEG, device=xa.device), diagonal=1)
        x = self._seq_scatter(x)
        for blk in dec.blocks:
            x = _decoder_block_full(blk, x, xa, causal)
        return self.logits(dec.ln(self._seq_gather(x)))


def _decoder_block_full(blk: Block, h: torch.Tensor, xa: torch.Tensor,
                        causal: torch.Tensor) -> torch.Tensor:
    """One decoder block in the full-sequence (teacher-forced) form: causal
    self-attention, cross-attention over all of ``xa``, MLP."""
    h = blk.mha_block(h, causal)
    q = _split_heads(blk.cross.query(blk.cross_ln(h)), blk.cross.n_head)
    k = _split_heads(blk.cross.key(xa), blk.cross.n_head)
    v = _split_heads(blk.cross.value(xa), blk.cross.n_head)
    o, _ = _attend(q, k, v)
    return blk.mlp_block(h + blk.cross.out(_merge_heads(o)))


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Whisper:
    """Random-init model, drawn from ``generator`` (which must live on
    ``device``) with the JAX package's distributions: linear and conv weights
    N(0, 1/fan_in), zero biases, unit layer-norm gains, token embedding
    N(0, 0.02²), sinusoidal encoder positions, zero decoder positions. The
    self-attention q/k/v weights are drawn fused (``qkv``), k's bias zero."""
    device = resolve_device(device)
    model = Whisper.empty(cfg, dtype, device)

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=device) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, mod.in_features ** -0.5)
            elif isinstance(mod, nn.Conv1d):
                normal_(mod.weight, (mod.in_channels * mod.kernel_size[0]) ** -0.5)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        normal_(model.decoder.tok_emb, 0.02)
        model.decoder.pos_emb.zero_()
        model.encoder.pos_emb.copy_(
            torch.from_numpy(_sinusoids(cfg.n_audio_ctx, cfg.n_audio_state)))
    return model


def encoder_flops(cfg: WhisperConfig, n_tokens: int) -> int:
    """Hand-counted matmul FLOPs of one encode of ``n_tokens`` output
    positions (mel frames / 2): per layer the four attention projections,
    the MLP and the two attention products; the conv stem's two k = 3
    convolutions at 2t (stride 1) and t (stride 2) positions."""
    d, ff, t, n_layer = cfg.n_audio_state, 4 * cfg.n_audio_state, n_tokens, cfg.n_audio_layer
    per_layer = 4 * 2 * t * d * d + 2 * 2 * t * d * ff + 2 * 2 * t * t * d
    stem = 2 * (2 * t) * 3 * cfg.n_mels * d + 2 * t * 3 * d * d
    return n_layer * per_layer + stem
