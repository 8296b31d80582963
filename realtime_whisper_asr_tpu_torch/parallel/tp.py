"""Tensor-parallel Whisper: Megatron's linears over a mesh's model group.

What XLA derives from the JAX package's parameter shardings
(``realtime_whisper_asr_tpu/parallel/sharding.py``), spelled out in
modules (``sharding.py`` holds the table of which tensor splits how):

- column-parallel linears (self-attention qkv, cross-attention query, key
  and value, fc1) hold their output features' rows: the input enters
  through ``copy_to_tp`` (or, under sequence parallelism, is all-gathered
  over the sequence), no collective in the forward;
- row-parallel linears (the attention outputs, fc2) hold their input
  features' columns: the partial products are all-reduced (reduce-scattered
  over the sequence under sequence parallelism). The bias is added once,
  by model rank 0 inside its partial, with the single-card ``Linear``'s own
  rounding (fused at f32, after the rounded product at 16 bits): a group of
  one computes the single-card linear bit for bit. Its gradient reaches
  every rank whole;
- the int8 tiers: a column-parallel ``Int8Linear`` quantizes its replicated
  input as the single-card one (all-gathered over the sequence first under
  sequence parallelism); a row-parallel one takes the row's absmax over the
  group (a local max, then all-reduce MAX), all-reduces its int32 partial
  products as int32 (reduce-scatters them over the sequence under sequence
  parallelism), then scales: every cross-rank sum is an exact integer sum,
  as the JAX package's partitioned ``dot_general`` with
  ``preferred_element_type=int32``; the int8 KV caches are per head and
  need nothing across ranks;
- attention holds H / tp heads; the decode's cross-attention capture sums
  its local heads with their slice of the alignment mask and all-reduces;
- the tied embedding splits d: rows are all-gathered, the logits head
  contracts this rank's slice of d and all-reduces (int32 for the int8
  head);
- sequence parallelism (``model.activation_sharding``): between the
  tensor-parallel linears the layer norms and residuals hold T / tp
  positions of each row; a block's layer-norm parameters then see a part of
  the positions, so their gradients are all-reduced (``copy_to_tp``).

The int4 tiers are not sharded: their packed-int4 kernel quantizes each row
over its local K inside the kernel, where a row-parallel product needs the
whole row's scale.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.autograd import Function

from realtime_whisper_asr_tpu_torch.models.whisper import model as M
from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.quant import tier_layout
from realtime_whisper_asr_tpu_torch.ops.int8_matmul import int8_matmul, quantize_rows
from realtime_whisper_asr_tpu_torch.parallel import collectives as C


class TensorParallel:
    """A model's tensor-parallel group, this process's place in it, and
    whether the sequence-parallel region is on (set while ``encode`` or
    ``decode_full`` runs under ``model.activation_sharding``)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.seq = False

    def local(self, n: int, what: str) -> int:
        if n % self.size:
            raise ValueError(f"{what} ({n}) does not split over {self.size} model ranks")
        return n // self.size


class _OnRank0(Function):
    """The bias of a row-parallel partial: itself on rank 0, zeros
    elsewhere, so the reduce adds it once; its gradient passes to every
    rank (each holds the whole upstream gradient)."""

    @staticmethod
    def forward(ctx, b, keep):
        return b.view_as(b) if keep else torch.zeros_like(b)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnLinear(M.Linear):
    """Output rows of a linear. ``seq_input``: the input is the residual
    stream (sequence-split under sequence parallelism), not the encoder
    output the cross-attention's key and value read."""

    def __init__(self, d_in, d_out, tp: TensorParallel, seq_input: bool, bias=True, **factory):
        super().__init__(d_in, d_out, bias=bias, **factory)
        self.tp, self.seq_input = tp, seq_input

    def forward(self, x):
        if self.tp.seq and self.seq_input:
            x = C.all_gather_seq(x, self.tp.group)
        else:
            x = C.copy_to_tp(x, self.tp.group)
        return super().forward(x)


class RowLinear(M.Linear):
    """Input columns of a linear: partial products reduced over the group."""

    def __init__(self, d_in, d_out, tp: TensorParallel, bias=True, **factory):
        super().__init__(d_in, d_out, bias=bias, **factory)
        self.tp = tp

    def forward(self, x):
        bias = None if self.bias is None else _OnRank0.apply(self.bias, self.tp.rank == 0)
        y = M._linear(x, self.weight, bias)
        if self.tp.seq:
            return C.reduce_scatter_seq(y, self.tp.group)
        return C.reduce_from_tp(y, self.tp.group)


class ColumnInt8Linear(M.Int8Linear):
    """Output rows of an ``Int8Linear``; ``seq_input`` as ``ColumnLinear``'s."""

    def __init__(self, d_in, d_out, tp: TensorParallel, seq_input: bool, bias=True, dtype=None,
                 device=None):
        super().__init__(d_in, d_out, bias, dtype, device)
        self.tp, self.seq_input = tp, seq_input

    def forward(self, x):
        if self.tp.seq and self.seq_input:
            x = C.all_gather_seq(x, self.tp.group)
        return super().forward(x)


class RowInt8Linear(M.Int8Linear):
    """A row-parallel ``Int8Linear``: the whole row's absmax, the int32
    partial products all-reduced as int32 (reduce-scattered over the
    sequence under sequence parallelism), then ``* sx * s``, then the bias."""

    def __init__(self, d_in, d_out, tp: TensorParallel, bias=True, dtype=None, device=None):
        super().__init__(d_in, d_out, bias, dtype, device)
        self.tp = tp

    def forward(self, x):
        group = self.tp.group
        xq, sx = quantize_rows(x, self.compiled, lambda m: C.all_reduce_max(m, group))
        y = int8_matmul(xq.reshape(-1, self.in_features), self.q).reshape(
            *x.shape[:-1], self.out_features)
        if self.tp.seq:
            y, sx = C.reduce_scatter_seq(y, group), C.scatter_seq(sx, group)
        else:
            y = C.all_reduce_sum(y, group)
        y = (y.float() * sx * self.s).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Int8EmbeddingTP(M.Int8Embedding):
    """The int8 tied embedding over d / tp columns: rows all-gathered; the
    logits quantize the replicated input row whole (its absmax needs no
    collective), contract this rank's columns and all-reduce the int32
    partial products."""

    def __init__(self, n_vocab: int, d_local: int, tp: TensorParallel, device=None):
        super().__init__(n_vocab, d_local, device)
        self.tp = tp

    def rows(self, tokens):
        return C.gather_from_tp(super().rows(tokens), self.tp.group)

    def logits(self, x):
        xq, sx = quantize_rows(x, self.compiled)
        d = self.q.shape[1]
        xq = xq[..., self.tp.rank * d : (self.tp.rank + 1) * d].reshape(-1, d)
        y = C.all_reduce_sum(int8_matmul(xq, self.q), self.tp.group)[:, : self.n_vocab]
        return y.reshape(*x.shape[:-1], self.n_vocab).float() * sx * self.s


class LayerNormTP(M.LayerNorm):
    """A block's layer norm: under sequence parallelism it normalizes this
    rank's positions, and its parameters' gradients are all-reduced."""

    def __init__(self, d: int, tp: TensorParallel, **factory):
        super().__init__(d, **factory)
        self.tp = tp

    def forward(self, x):
        if not self.tp.seq:
            return super().forward(x)
        w = C.copy_to_tp(self.weight, self.tp.group)
        b = C.copy_to_tp(self.bias, self.tp.group)
        return F.layer_norm(x.float(), self.normalized_shape, w.float(), b.float(),
                            self.eps).to(x.dtype)


#: column-parallel block linears (True: they read the residual stream)
_COLUMN = {"attn.qkv": True, "cross.query": True, "cross.key": False, "cross.value": False,
           "fc1": True}
_ROW = ("attn.out", "cross.out", "fc2")
_BLOCK_NORMS = ("attn_ln", "cross_ln", "mlp_ln")


def _shard_block(blk: M.Block, tp: TensorParallel, factory: dict) -> None:
    """Swap a block's linears and norms for their tensor-parallel forms (on
    the meta device, before the model is materialized)."""
    for path in list(_COLUMN) + list(_ROW):
        parent_name, _, name = path.rpartition(".")
        if parent_name and not hasattr(blk, parent_name):  # an encoder block's cross
            continue
        parent = getattr(blk, parent_name) if parent_name else blk
        old = getattr(parent, name)
        bias = old.bias is not None
        int8 = isinstance(old, M.Int8Linear)
        if path in _COLUMN:
            d_out = tp.local(old.out_features, path)
            cls = ColumnInt8Linear if int8 else ColumnLinear
            new = cls(old.in_features, d_out, tp, _COLUMN[path], bias, **factory)
        else:
            d_in = tp.local(old.in_features, path)
            new = (RowInt8Linear(d_in, old.out_features, tp, bias, **factory) if int8
                   else RowLinear(d_in, old.out_features, tp, bias, **factory))
        setattr(parent, name, new)
    for name in _BLOCK_NORMS:
        if hasattr(blk, name):
            setattr(blk, name, LayerNormTP(getattr(blk, name).normalized_shape[0], tp,
                                           **factory))
    blk.attn.n_head = tp.local(blk.attn.n_head, "heads")
    if hasattr(blk, "cross"):
        blk.cross.n_head = tp.local(blk.cross.n_head, "heads")


class TensorParallelWhisper(M.Whisper):
    """A ``Whisper`` whose block linears, heads and tied embedding are this
    model rank's shards (``sharding.shard_model`` builds and fills it).
    ``device="meta"`` gives the training skeleton."""

    def __init__(self, cfg: WhisperConfig, tp: TensorParallel, dtype=torch.float32,
                 device=None, quantization: Optional[str] = None):
        enc_kind, dec_kind, head_int8 = tier_layout(quantization)
        if "int4" in (enc_kind, dec_kind):
            raise ValueError(f"quantization {quantization!r} under tensor parallelism: the "
                             f"int4 tiers are not sharded (their kernel quantizes rows over "
                             f"its local K)")
        super().__init__(cfg, dtype, "meta", quantization)
        self.tp = tp
        factory = {"dtype": dtype, "device": "meta"}
        for blk in list(self.encoder.blocks) + list(self.decoder.blocks):
            _shard_block(blk, tp, factory)
        d_local = tp.local(cfg.n_text_state, "n_text_state")
        del self.decoder.tok_emb
        if head_int8:
            self.decoder.tok_emb = Int8EmbeddingTP(cfg.n_vocab, d_local, tp, device="meta")
        else:
            self.decoder.tok_emb = nn.Parameter(torch.empty(cfg.n_vocab, d_local, **factory))
        for mod in self.modules():
            if isinstance(mod, (M._QuantLinear, M.Int8Embedding)):
                mod.compiled = self.kv_quant
        if device is not None and torch.device(device).type != "meta":
            self.to_empty(device=device)

    @property
    def _text_heads(self) -> int:
        return self.cfg.n_text_head // self.tp.size

    # ------------------------------------------------- sequence parallelism

    @contextlib.contextmanager
    def _seq_region(self):
        """The sequence-parallel flag for one encode or teacher-forced
        decode: on under ``model.activation_sharding`` of this model's group."""
        scope = M._ACT_SHARDING
        if scope is not None and scope.group is not self.tp.group:
            raise ValueError("activation_sharding of another group than this model's")
        prev, self.tp.seq = self.tp.seq, scope is not None
        try:
            yield
        finally:
            self.tp.seq = prev

    def _seq_scatter(self, x):
        if not self.tp.seq:
            return x
        if x.shape[1] % self.tp.size:  # refused, not padded
            raise ValueError(f"sequence parallelism over {self.tp.size} ranks needs the "
                             f"sequence ({x.shape[1]} positions) to divide by it")
        return C.scatter_seq(x, self.tp.group)

    def _seq_gather(self, x):
        return C.gather_seq(x, self.tp.group) if self.tp.seq else x

    def encode(self, mel):
        with self._seq_region():
            return super().encode(mel)

    def decode_full(self, tokens, xa):
        with self._seq_region():
            return super().decode_full(tokens, xa)

    # ---------------------------------------------------- embedding, head

    def _emb_rows(self, tokens):
        emb = self.decoder.tok_emb
        if isinstance(emb, M.Int8Embedding):
            return emb.rows(tokens)
        return C.gather_from_tp(emb[tokens], self.tp.group)

    def logits(self, x):
        emb = self.decoder.tok_emb
        if isinstance(emb, M.Int8Embedding):
            return emb.logits(x)
        part = torch.matmul(C.split_to_tp(x, self.tp.group).float(), emb.float().t())
        return C.reduce_from_tp(part, self.tp.group)

    # ------------------------------------------------------------ decode

    def _decoder_layers(self, x, pos, mask, cache, alignment_mask, anc=None):
        if anc is not None:
            raise NotImplementedError("beam search under tensor parallelism is not ported")
        h = self._text_heads
        local = (None if alignment_mask is None
                 else alignment_mask[:, self.tp.rank * h : (self.tp.rank + 1) * h])
        x, xattn = super()._decoder_layers(x, pos, mask, cache, local)
        return x, (None if xattn is None else C.all_reduce_sum(xattn, self.tp.group))
