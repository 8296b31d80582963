"""Whisper training steps: teacher-forced cross-entropy, on one card or a mesh.

Port of ``realtime_whisper_asr_tpu/train/train_step.py``: ``make_train_step``
is the single-card step, ``make_sharded_train_step`` the dp × tp one over a
``parallel.Mesh`` (the GPipe step is ``parallel.pipeline.make_pp_train_step``).

- ``TrainState``: ``params`` (name -> tensor: every entry of
  ``model.Whisper``'s state dict, each a leaf that requires grad, the JAX
  tree's leaves in the port's layout), the optimizer's state (``optim``)
  and the step count.
- ``loss_fn``: the masked mean NLL of ``decode_full(encode(mel))``, the
  model run by ``torch.func.functional_call`` on a parameterless skeleton
  (``Whisper.forward``), inside a non-reentrant ``torch.utils.checkpoint``:
  the backward recomputes the whole forward, as the JAX package's
  ``jax.checkpoint(nothing_saveable)`` does.
- ``loss_and_grads``: ``jax.value_and_grad`` of it under
  ``device.exact_kernels`` (IEEE f32 and deterministic cuDNN in the forward
  and the backward), the frozen entries' gradients zeroed.
- The step updates the parameters and the moments in place under
  ``no_grad``, the stand-in for ``donate_argnums``.
- Under a mesh (``make_train_state(mesh=)``, ``make_sharded_train_step``)
  the params are this rank's shards (``parallel.sharding``), drawn whole
  from the seeded generator and sliced, so the sharded init is the
  unsharded one; the model is a ``parallel.tp.TensorParallelWhisper``
  skeleton, whose region functions are recomputed in the backward like any
  other op. Each data rank runs its rows; the loss is its
  ``sum(nll·mask)`` over the whole batch's ``sum(mask)`` (an all-reduce over
  the data group), so the gradients are summed over the data group, not
  averaged. ``sequence_parallel`` runs the step inside
  ``model.activation_sharding``. The optimizer gets the gradients as
  ``optim.ShardedLeaves``: the global norm is the whole tree's.

Two entries differ from the JAX tree in layout, and training keeps them
equal to it:

- ``encoder.pos_emb`` is a buffer of the module but a leaf of the JAX tree
  (``realtime_whisper_asr_tpu/models/whisper/model.py:437``), trained and
  decayed by optax: here it trains too;
- the fused ``attn.qkv.bias`` carries a k slice the JAX tree does not have
  (``convert._fused_qkv``). Softmax ignores it, so its gradient is rounding
  noise; Adam would turn that into steps of ~lr. Its gradient is zeroed, so
  its moments stay 0, its update is 0 and it adds nothing to the global
  norm: it stays exactly 0.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, NamedTuple

import torch

from realtime_whisper_asr_tpu_torch.device import exact_kernels, resolve_device
from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.model import (
    Whisper,
    activation_sharding,
    encoder_flops,
    init_params,
)
from realtime_whisper_asr_tpu_torch.train import optim as O

_K_BIAS = "attn.qkv.bias"


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: int


@functools.lru_cache(maxsize=8)
def _skeleton(cfg: WhisperConfig) -> Whisper:
    """The model's module tree with no storage: ``loss_fn`` runs it over the
    tensors of ``params``."""
    return Whisper(cfg, device="meta")


@functools.lru_cache(maxsize=8)
def _tp_skeleton(cfg: WhisperConfig, mesh) -> Whisper:
    """The tensor-parallel module tree of one mesh's model group, no storage."""
    from realtime_whisper_asr_tpu_torch.parallel.tp import TensorParallel, TensorParallelWhisper

    return TensorParallelWhisper(cfg, TensorParallel(mesh.model_group), device="meta")


def _forward(params: dict, model: Whisper, mel: torch.Tensor,
             tokens_in: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(model, params, (mel, tokens_in), strict=True)


def loss_fn(params: dict, cfg: WhisperConfig, mel, tokens_in, tokens_out, mask) -> torch.Tensor:
    """mel (B, T, M); tokens_in/out (B, S) long; mask (B, S) 1 = count. Mean NLL."""
    return _loss(params, _skeleton(cfg), mel, tokens_in, tokens_out, mask)


def _loss(params: dict, model: Whisper, mel, tokens_in, tokens_out, mask,
          count=None) -> torch.Tensor:
    logits = torch.utils.checkpoint.checkpoint(_forward, params, model, mel, tokens_in,
                                               use_reentrant=False)  # (B, S, V) f32
    return _masked_nll(logits, tokens_out, mask, count)


def _masked_nll(logits, tokens_out, mask, count=None) -> torch.Tensor:
    """sum(nll·mask) over ``count`` (default: sum(mask)), at least 1."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens_out[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask) if count is None else count,
                                               min=1.0)


def _zero_frozen(grads: dict) -> None:
    """Zero the gradient of every fused k bias slice (kept exactly 0)."""
    for name, g in grads.items():
        if name.endswith(_K_BIAS):
            d = g.shape[0] // 3
            g[d:2 * d] = 0.0


def loss_and_grads(params: dict, cfg: WhisperConfig, batch: dict):
    """(loss, grads): ``jax.value_and_grad(loss_fn)`` over every entry of
    ``params``, the frozen slices' gradients zeroed."""
    return _loss_and_grads(params, _skeleton(cfg), batch)


def _loss_and_grads(params: dict, model: Whisper, batch: dict, count=None):
    """``loss_and_grads`` over ``model``'s module tree, the loss divided by
    ``count`` (default: the batch's mask count)."""
    with exact_kernels():
        loss = _loss(params, model, batch["mel"], batch["tokens_in"], batch["tokens_out"],
                     batch["mask"], count)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
    grads = dict(zip(params, grads))
    _zero_frozen(grads)
    return loss.detach(), grads


def trainable(state: dict, device, dtype=torch.float32) -> dict:
    """A state dict of ``model.Whisper`` (any device) as training params:
    float tensors in ``dtype`` on ``device``, each a leaf that requires grad."""
    return {k: v.detach().to(device=device, dtype=dtype).clone().requires_grad_(True)
            for k, v in state.items()}


def make_train_state(cfg: WhisperConfig, generator: torch.Generator, optimizer=None,
                     dtype=torch.float32, device="cuda", mesh=None):
    """Random-init TrainState on ``device`` (the card unless asked
    otherwise; raises without CUDA), drawn from ``generator`` (which lives
    on that device) by ``model.init_params``. Returns (state, optimizer);
    ``optimizer`` defaults to ``optim.adamw(1e-5)``, as the JAX package's.
    With ``mesh`` (a ``parallel.Mesh``), on the mesh's device: the whole
    init, then this rank's shards of it (``sharding.shard_params``), before
    ``optimizer.init``, so the moments are shards too."""
    optimizer = optimizer or O.adamw(1e-5)
    device = resolve_device(device) if mesh is None else mesh.device
    model = init_params(cfg, generator, dtype, device)
    state = model.state_dict(keep_vars=True)
    if mesh is not None:
        from realtime_whisper_asr_tpu_torch.parallel.sharding import shard_params

        state = shard_params(state, mesh)
    params = {k: v.requires_grad_(True) for k, v in state.items()}
    return TrainState(params, optimizer.init(params), 0), optimizer


def make_train_step(cfg: WhisperConfig, optimizer=None, device="cuda"):
    """Returns (train_step, shard_batch), the single-card counterpart of
    the JAX package's ``make_sharded_train_step``.

    ``train_step(state, batch) -> (state, loss)``: batch layout {"mel":
    (B, T, M), "tokens_in": (B, S), "tokens_out": (B, S), "mask": (B, S)} on
    ``device``; the loss a 0-d tensor there (reading it syncs). The state's
    tensors are updated in place. ``shard_batch`` puts a batch (numpy or
    tensors) on ``device``, tokens as int64."""
    optimizer = optimizer or O.adamw(1e-5)
    dev = resolve_device(device)

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(state.params, cfg, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        O.apply_updates(state.params, updates)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return train_step, functools.partial(_to_device, device=dev)


def _to_device(batch: dict, device: torch.device) -> dict:
    """A batch (numpy or tensors) on ``device``, tokens as int64, the rest f32."""
    return {k: torch.as_tensor(v).to(device, torch.int64 if k.startswith("tokens")
                                     else torch.float32)
            for k, v in batch.items()}


def make_sharded_train_step(cfg: WhisperConfig, mesh, optimizer=None,
                            sequence_parallel: bool = False):
    """Returns (train_step, shard_batch) over a ``parallel.Mesh``, the JAX
    package's ``make_sharded_train_step``.

    ``train_step(state, batch)``: ``state`` from ``make_train_state(mesh=)``,
    ``batch`` this data rank's rows on the mesh's device; returns the new
    state and the whole batch's loss (equal on every rank). ``shard_batch``
    takes a whole batch (numpy or tensors; B divisible by the data axis) to
    this rank's rows on the mesh's device.

    ``sequence_parallel``: Megatron-SP inside the tensor-parallel group
    (``model.activation_sharding``): the layer norms and residuals between
    the tensor-parallel linears hold 1/tp of the sequence, each block
    boundary's all-reduce a reduce-scatter and an all-gather; the same
    function as the plain dp × tp step."""
    from realtime_whisper_asr_tpu_torch.parallel.sharding import data_sharding, split_names

    optimizer = optimizer or O.adamw(1e-5)
    rows = data_sharding(mesh)

    def train_step(state: TrainState, batch: dict):
        loss, grads = sharded_loss_and_grads(state.params, cfg, batch, mesh, sequence_parallel)
        grads = O.ShardedLeaves(grads, split_names(grads), mesh.model_group)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        O.apply_updates(state.params, updates)
        return TrainState(state.params, opt_state, state.step + 1), loss

    def shard_batch(batch: dict) -> dict:
        return _to_device(rows(batch), mesh.device)

    return train_step, shard_batch


def sharded_loss_and_grads(params: dict, cfg: WhisperConfig, batch: dict, mesh,
                           sequence_parallel: bool = False):
    """``loss_and_grads`` of the whole batch over a ``parallel.Mesh``: the
    loss on every rank, and this rank's shards of the gradients. ``batch``
    is this data rank's rows; each data rank divides its rows' NLL sum by
    the whole batch's mask count (an all-reduce over the data group), and
    the losses and the gradients are summed over the data group."""
    from realtime_whisper_asr_tpu_torch.parallel import collectives as C
    from realtime_whisper_asr_tpu_torch.parallel.sharding import sequence_sharding

    count = C.all_reduce_sum(batch["mask"].sum(), mesh.data_group)
    scope = (activation_sharding(sequence_sharding(mesh)) if sequence_parallel
             else contextlib.nullcontext())
    with scope:
        loss, grads = _loss_and_grads(params, _tp_skeleton(cfg, mesh), batch, count)
    C.all_reduce_sum_(list(grads.values()), mesh.data_group)
    return C.all_reduce_sum(loss, mesh.data_group), grads


def eval_loss(params: dict, cfg: WhisperConfig, batch: dict) -> torch.Tensor:
    """``loss_fn``'s value without a graph (validation)."""
    with torch.no_grad(), exact_kernels():
        logits = _forward(params, _skeleton(cfg), batch["mel"], batch["tokens_in"])
        return _masked_nll(logits, batch["tokens_out"], batch["mask"])


def step_flops(cfg: WhisperConfig, batch: int, n_frames: int, n_tokens: int) -> int:
    """Hand-counted matmul FLOPs of one train step over ``batch`` rows of
    ``n_frames`` mel frames and ``n_tokens`` tokens: four forwards' worth
    (the forward, its recompute in the backward, and the backward's two
    products per forward product). A forward is ``encoder_flops`` at
    ``n_frames / 2`` positions, per decoder layer the self-attention's four
    projections and two products, the cross-attention's q and out
    projections over the tokens, k and v over the audio positions and its
    two products, the MLP; and the tied head."""
    a, s, d = n_frames // 2, n_tokens, cfg.n_text_state
    per_layer = (4 * 2 * s * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * d + 2 * 2 * a * d * d
                 + 2 * 2 * s * a * d + 2 * 2 * s * d * 4 * d)
    forward = encoder_flops(cfg, a) + cfg.n_text_layer * per_layer + 2 * s * d * cfg.n_vocab
    return 4 * batch * forward
