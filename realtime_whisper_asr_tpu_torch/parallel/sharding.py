"""How each tensor of the port's state dict splits over a mesh's model group.

Port of ``realtime_whisper_asr_tpu/parallel/sharding.py``: Megatron tensor
parallelism over the ``model`` axis, as a table over the state dict's names
(torch's (out, in) layout) instead of a ``PartitionSpec`` tree. Each rule
gives the split and the reason:

- ``"qkv"``: the fused ``[wq | wk | wv]`` rows (``model.SelfAttention``)
  split per head within each of q, k and v: rank r holds the rows of heads
  [r·H/tp, (r+1)·H/tp) of all three (a contiguous third of the fused rows
  would give one rank all of q);
- ``"out"``: column-parallel, dim 0 (output features);
- ``"in"``: row-parallel, the last dim (input features); for the tied
  embedding (V, d) that is d, the JAX package's ``P(None, "model")``;
- ``"replicated"``: every rank holds it whole.

The int8 tiers follow ``_adapt_to_quantized``: ``q`` takes its dense
weight's split, a per-output scale ``s`` follows an output split and is
replicated under a row-parallel one, and the embedding's per-row ``s`` (V,)
is replicated. The int4 tiers are refused (``tp.py``).

The port replicates what the JAX package splits where replication is the
simpler program and costs little memory: the conv stem (5.4 M of
large-v3's 1.55 B parameters, 0.35 %) and the positional embeddings (the
encoder's 1.9 M, the decoder's 0.57 M).

``shard_params`` gives a rank's local tensors, ``shard_model`` a
``TensorParallelWhisper`` over them, ``gather_params`` the whole state back
on every rank. ``data_sharding`` gives a rank's rows of a batch and
``sequence_sharding`` the sequence-parallel scope of
``model.activation_sharding``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
import torch.distributed as dist

from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.quant import detect_quantization, quantize
from realtime_whisper_asr_tpu_torch.parallel.mesh import Mesh

QKV, OUT, IN, REPLICATED = "qkv", "out", "in", "replicated"

_BLOCK = r"^(encoder|decoder)\.blocks\.\d+\."

#: (pattern over state-dict names, split, reason); the first match rules
RULES = (
    (r"^encoder\.conv[12]\.(weight|bias)$", REPLICATED,
     "the conv stem: 0.35 % of large-v3's parameters, run whole on every rank"),
    (r"^(encoder|decoder)\.pos_emb$", REPLICATED,
     "positional embeddings: 1.9 M (encoder) and 0.57 M (decoder) parameters"),
    (_BLOCK + r"(attn_ln|cross_ln|mlp_ln)\.(weight|bias)$", REPLICATED,
     "a block's layer norm: each rank normalizes its rows (its positions under sequence "
     "parallelism, where the gradients are all-reduced)"),
    (r"^(encoder\.ln_post|decoder\.ln)\.(weight|bias)$", REPLICATED,
     "the final layer norms, after the stacks"),
    (_BLOCK + r"attn\.qkv\.(weight|bias|q|s)$", QKV,
     "the fused [wq | wk | wv]: per head within each of q, k and v"),
    (_BLOCK + r"(cross\.query|cross\.key|cross\.value|fc1)\.(weight|bias|q|s)$", OUT,
     "column-parallel: the output features (heads, hidden units)"),
    (_BLOCK + r"(attn\.out|cross\.out|fc2)\.(weight|q)$", IN,
     "row-parallel: the input features; the partial products are reduced"),
    (_BLOCK + r"(attn\.out|cross\.out|fc2)\.bias$", REPLICATED,
     "a row-parallel bias: added once, by model rank 0 inside its partial"),
    (_BLOCK + r"(attn\.out|cross\.out|fc2)\.s$", REPLICATED,
     "a row-parallel int8 linear's per-output scales: applied after the int32 reduce"),
    (r"^decoder\.tok_emb(\.q)?$", IN,
     "the tied embedding splits d: rows all-gathered, logits reduced over d"),
    (r"^decoder\.tok_emb\.s$", REPLICATED, "the int8 embedding's per-vocabulary-row scales"),
)


def split_of(name: str) -> tuple[str, str]:
    """(split, reason) of a state-dict entry; a name no rule covers raises."""
    for pattern, split, reason in RULES:
        if re.search(pattern, name):
            return split, reason
    raise KeyError(f"no sharding rule for {name!r}")


def whisper_param_shardings(names) -> dict:
    """name -> split of every entry of a state dict (or of its names): the
    JAX package's ``PartitionSpec`` tree as a table. Raises where no rule
    covers an entry."""
    return {k: split_of(k)[0] for k in names}


def split_names(names) -> frozenset:
    """The entries of ``names`` that split over the model group."""
    return frozenset(n for n in names if split_of(n)[0] != REPLICATED)


def shard_tensor(t: torch.Tensor, split: str, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s part of ``t`` (a view where it can be)."""
    if split == REPLICATED:
        return t
    dim = 0 if split in (QKV, OUT) else t.dim() - 1
    n = t.shape[dim] // (3 if split == QKV else 1)
    if n % size:
        raise ValueError(f"{tuple(t.shape)} does not split over {size} model ranks ({split})")
    if split == QKV:
        return t.unflatten(0, (3, size, n // size))[:, rank].flatten(0, 1)
    return t.narrow(dim, rank * (t.shape[dim] // size), t.shape[dim] // size)


def _refuse_int4(state: dict) -> Optional[str]:
    tier = detect_quantization(state)
    if tier is not None and tier.startswith("int4"):
        raise ValueError(f"a {tier} state under tensor parallelism: the int4 tiers are not "
                         f"sharded (their kernel quantizes rows over its local K)")
    return tier


def shard_params(state: dict, mesh: Mesh) -> dict:
    """This rank's tensors of a whole state dict (any device), each a new
    tensor on the state's device."""
    _refuse_int4(state)
    return {k: shard_tensor(v, split_of(k)[0], mesh.model_rank, mesh.model).clone()
            for k, v in state.items()}


def shard_model(state: dict, cfg: WhisperConfig, mesh: Mesh, quantization: Optional[str] = None,
                dtype=None, local: bool = False):
    """A ``TensorParallelWhisper`` on the mesh's device holding this rank's
    shards of ``state``: a whole state dict (dense or pre-quantized; a
    ``quantization`` tier is applied first, as the ASR applies it at load),
    or with ``local`` this rank's shards already (``load_checkpoint_sharded``,
    whose tier is the one its tensors carry). Floats cast to ``dtype`` (default:
    the state's), quantized scales kept f32."""
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import _cast_floats
    from realtime_whisper_asr_tpu_torch.parallel.tp import TensorParallel, TensorParallelWhisper

    tier = quantization or _refuse_int4(state)
    if not local:
        state = shard_params(quantize(state, tier), mesh)
    dtype = dtype or state["decoder.pos_emb"].dtype
    model = TensorParallelWhisper(cfg, TensorParallel(mesh.model_group), dtype, mesh.device,
                                  tier)
    model.load_state_dict(_cast_floats(state, dtype))
    return model.requires_grad_(False).eval()


def _gather_tensor(t: torch.Tensor, split: str, group) -> torch.Tensor:
    from realtime_whisper_asr_tpu_torch.parallel.collectives import _gather

    if split == REPLICATED:
        return t
    if split == OUT:
        return _gather(t, 0, group)
    if split == IN:
        return _gather(t, t.dim() - 1, group)
    size = dist.get_world_size(group)  # QKV: [q_r | k_r | v_r] per rank -> [q | k | v]
    parts = _gather(t, 0, group).unflatten(0, (size, 3, -1))
    return parts.transpose(0, 1).flatten(0, 2)


@torch.no_grad()
def gather_params(local: dict, mesh: Mesh) -> dict:
    """The whole state dict on every rank from each rank's shards (the
    inverse of ``shard_params``)."""
    return {k: _gather_tensor(v.detach(), split_of(k)[0], mesh.model_group)
            for k, v in local.items()}


def data_sharding(mesh: Mesh):
    """A function from a batch (a dict of arrays or tensors, rows first) to
    this rank's rows of it: data rank i takes the i-th of ``mesh.data``
    equal parts."""

    def rows(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % mesh.data:
                raise ValueError(f"batch {b} not divisible by the data axis ({mesh.data})")
            n = b // mesh.data
            out[k] = v[mesh.data_rank * n : (mesh.data_rank + 1) * n]
        return out

    return rows


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceSharding:
    """The sequence-parallel scope of ``model.activation_sharding``: the
    sequence of each data rank's rows splits over this model group."""

    group: dist.ProcessGroup


def sequence_sharding(mesh: Mesh) -> SequenceSharding:
    """Megatron-SP over the mesh's model group: between the tensor-parallel
    blocks each rank keeps 1/tp of the sequence, and each block boundary's
    all-reduce becomes a reduce-scatter and an all-gather (the same bytes,
    tp times less activation memory)."""
    return SequenceSharding(mesh.model_group)
