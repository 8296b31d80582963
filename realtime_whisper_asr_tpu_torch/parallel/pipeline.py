"""Pipeline parallelism (GPipe) over the layer stacks, one stage a rank.

Port of ``realtime_whisper_asr_tpu/parallel/pipeline.py``. Stage s of S
holds encoder and decoder blocks [s·L/S, (s+1)·L/S); M microbatches go
through the stages in M + S − 1 steps: stage s takes microbatch m from
stage s − 1 (``recv``), runs its blocks and hands the result to stage
s + 1 (``send``), so stage s works on microbatch m at step m + s. Two
pipelines run in sequence, as in the JAX package: the encoder's, then,
once the encoder output has reached every stage, the decoder's.

The JAX package rotates ``(h, xa)`` through the decoder stages together.
Here the encoder output reaches every stage by one broadcast from the last
stage, and each decoder stage reads its microbatch's rows of it: the same
arithmetic, with xa moved once instead of once a hop, and its gradient
summed back onto the last stage by one all-reduce.

Training (``make_pp_train_step``) runs a hand-written schedule: the
forward over all microbatches, each stage × microbatch inside a
non-reentrant ``torch.utils.checkpoint`` (GPipe's rematerialization: the
backward recomputes one stage × microbatch at a time), then
``torch.autograd.backward`` on each stored output with the gradient received
from the next stage, and the input's gradient sent to the previous one.
``torch.distributed.pipelining`` runs one chain of stages, which holds
neither the two pipelines nor the broadcast between them. The loss and the
ops before and after the pipelines (the conv stem and embedding on stage 0;
``ln_post``, the decoder's layer norm, the tied head and the loss on the
last stage) run once, over the whole batch, so the loss is
``sum(nll·mask) / sum(mask)`` as the plain step's; a replicated tensor's
gradient is the sum of the stages' own contributions (the tied embedding
is used at both ends), all-reduced over the stages.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from realtime_whisper_asr_tpu_torch.device import exact_kernels
from realtime_whisper_asr_tpu_torch.models.whisper import model as M
from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.parallel import collectives as C
from realtime_whisper_asr_tpu_torch.parallel.mesh import warm_up, world_device
from realtime_whisper_asr_tpu_torch.train import optim as O
from realtime_whisper_asr_tpu_torch.train.train_step import (
    TrainState,
    _masked_nll,
    _to_device,
    _zero_frozen,
)


@dataclasses.dataclass(eq=False)
class StageMesh:
    """A 1-D mesh of pipeline stages: rank s is stage s."""

    shape: dict  # {"stage": S}
    rank: int
    device: torch.device
    group: dist.ProcessGroup

    @property
    def stages(self) -> int:
        return self.shape["stage"]


def make_pp_mesh(n_stages: int) -> StageMesh:
    """The ('stage',) mesh over the joined world of ``n_stages`` ranks."""
    world = dist.get_world_size()
    if world < n_stages:
        raise ValueError(f"need {n_stages} devices, have {world}")
    if world > n_stages:
        raise ValueError(f"{n_stages} stages in a world of {world} ranks")
    group = dist.new_group(list(range(n_stages)))
    device = world_device()
    warm_up(group, device)
    return StageMesh({"stage": n_stages}, dist.get_rank(), device, group)


def _stage_range(n_layers: int, mesh: StageMesh) -> tuple[int, int]:
    if n_layers % mesh.stages:
        raise ValueError(f"{n_layers} layers not divisible by {mesh.stages} stages")
    per = n_layers // mesh.stages
    return mesh.rank * per, (mesh.rank + 1) * per


def _microbatches(x: torch.Tensor, n_micro: int) -> list:
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return list(x.split(b // n_micro))


def _buffer(like: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of ``like``'s shape, dtype and device, to receive into."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _forward_stages(mesh: StageMesh, fn: Callable, firsts: list, like: torch.Tensor,
                    n_micro: int, grad: bool) -> tuple[list, list]:
    """Stage s's part of a pipeline: for each microbatch m, its input (from
    ``firsts`` on stage 0, else received from stage s − 1, shaped as
    ``like``), ``fn(m, input)``, the output sent on to stage s + 1. With
    ``grad`` each input is a leaf that collects its gradient. Returns
    (inputs, outputs)."""
    s, last = mesh.rank, mesh.stages - 1
    ins, outs = [], []
    for m in range(n_micro):
        if s == 0:
            h = firsts[m].detach() if grad else firsts[m]
        else:
            h = _buffer(like)
            dist.recv(h, s - 1)
        if grad:
            h.requires_grad_(True)
        y = fn(m, h)
        if s < last:
            dist.send(y.detach().contiguous(), s + 1)
        ins.append(h)
        outs.append(y)
    return ins, outs


def _backward_stages(mesh: StageMesh, ins: list, outs: list) -> None:
    """The backward of ``_forward_stages`` on a stage other than the last:
    each output's gradient received from stage s + 1, and each input's
    gradient sent to stage s − 1 (stage 0 keeps them)."""
    s = mesh.rank
    if s < mesh.stages - 1:
        for y in outs:
            g = _buffer(y)
            dist.recv(g, s + 1)
            torch.autograd.backward(y, g)
    if s > 0:
        for h in ins:
            dist.send(h.grad.contiguous(), s - 1)


def _broadcast_from_last(x, like: torch.Tensor, mesh: StageMesh) -> torch.Tensor:
    """The last stage's ``x`` on every stage (``like`` gives the shape)."""
    buf = x.detach().contiguous() if mesh.rank == mesh.stages - 1 else _buffer(like)
    dist.broadcast(buf, mesh.stages - 1, group=mesh.group)
    return buf


def pipeline_blocks(mesh: StageMesh, body: Callable, x_mb: list, blocks) -> list:
    """Run a block stack as an S-stage pipeline over microbatches (no
    gradient). ``x_mb``: the M microbatch activations (stage 0's are
    ingested, the others' give the shape); ``blocks``: all L blocks of the
    stack (L divisible by S), of which stage s runs its L/S; ``body(h,
    blk)``: one block. Returns the M outputs on every stage, the same
    per-layer float ops as the plain stack on each microbatch."""
    lo, hi = _stage_range(len(blocks), mesh)

    def run(m, h):
        for blk in list(blocks)[lo:hi]:
            h = body(h, blk)
        return h

    _, outs = _forward_stages(mesh, run, x_mb, x_mb[0], len(x_mb), grad=False)
    if mesh.rank != mesh.stages - 1:
        outs = [None] * len(x_mb)
    return [_broadcast_from_last(y, x, mesh) for y, x in zip(outs, x_mb)]


def _encoder_blocks(model: M.Whisper, h: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    for blk in list(model.encoder.blocks)[lo:hi]:
        h = blk.mlp_block(blk.mha_block(h))
    return h


def _decoder_blocks(model: M.Whisper, h: torch.Tensor, xa: torch.Tensor, causal: torch.Tensor,
                    lo: int, hi: int) -> torch.Tensor:
    for blk in list(model.decoder.blocks)[lo:hi]:
        h = M._decoder_block_full(blk, h, xa, causal)
    return h


def _embed(model: M.Whisper, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``decode_full``'s input: token rows plus positions, in ``dtype``."""
    return (model._emb_rows(tokens) + model.decoder.pos_emb[: tokens.shape[1]]).to(dtype)


def _causal(t: int, device) -> torch.Tensor:
    return torch.triu(torch.full((t, t), M._NEG, device=device), diagonal=1)


@torch.no_grad()
def pp_encode(model: M.Whisper, mel: torch.Tensor, mesh: StageMesh,
              n_micro: int) -> torch.Tensor:
    """Pipeline-parallel ``model.encode``: the stem and ``ln_post`` whole,
    the transformer stack pipelined. mel (B, T, n_mels) -> (B, T/2, d) on
    every stage."""
    x_mb = _microbatches(model.encoder.stem(mel), n_micro)
    y = pipeline_blocks(mesh, lambda h, blk: blk.mlp_block(blk.mha_block(h)), x_mb,
                        model.encoder.blocks)
    return model.encoder.ln_post(torch.cat(y))


@torch.no_grad()
def pp_decode_full(model: M.Whisper, tokens: torch.Tensor, xa: torch.Tensor,
                   mesh: StageMesh, n_micro: int) -> torch.Tensor:
    """Pipeline-parallel ``model.decode_full``: each stage cross-attends
    over its microbatch's rows of xa (on every stage). tokens (B, S),
    xa (B, T, d) -> logits (B, S, V) f32 on every stage."""
    x = _embed(model, tokens, xa.dtype)
    causal = _causal(tokens.shape[1], xa.device)
    xa_mb = _microbatches(xa, n_micro)
    lo, hi = _stage_range(len(model.decoder.blocks), mesh)
    _, outs = _forward_stages(
        mesh, lambda m, h: _decoder_blocks(model, h, xa_mb[m], causal, lo, hi),
        _microbatches(x, n_micro), x[: x.shape[0] // n_micro], n_micro, grad=False)
    last = mesh.rank == mesh.stages - 1
    h = _broadcast_from_last(torch.cat(outs) if last else None, x, mesh)
    return model.logits(model.decoder.ln(h))


def _is_block(name: str) -> bool:
    return ".blocks." in name


def pp_param_shardings(mesh: StageMesh, names) -> dict:
    """name -> "stage" (a block's: held by its stage) or "replicated"."""
    return {k: "stage" if _is_block(k) else "replicated" for k in names}


def pp_shard_params(state: dict, cfg: WhisperConfig, mesh: StageMesh) -> dict:
    """This stage's entries of a whole state dict: every replicated one and
    the blocks of its layer ranges."""
    ranges = {"encoder": _stage_range(cfg.n_audio_layer, mesh),
              "decoder": _stage_range(cfg.n_text_layer, mesh)}

    def mine(name):
        if not _is_block(name):
            return True
        part, _, i = name.split(".")[:3]
        lo, hi = ranges[part]
        return lo <= int(i) < hi

    return {k: v for k, v in state.items() if mine(k)}


@torch.no_grad()
def pp_gather_params(local: dict, cfg: WhisperConfig, mesh: StageMesh) -> dict:
    """The whole state dict on every stage: each block entry broadcast from
    the stage that holds it (the inverse of ``pp_shard_params``)."""
    from realtime_whisper_asr_tpu_torch.train.train_step import _skeleton

    out = {}
    for name, t in _skeleton(cfg).state_dict().items():
        if not _is_block(name):
            out[name] = local[name].detach()
            continue
        part, _, i = name.split(".")[:3]
        n = cfg.n_audio_layer if part == "encoder" else cfg.n_text_layer
        owner = int(i) // (n // mesh.stages)
        buf = (local[name].detach().clone() if mesh.rank == owner
               else torch.empty(t.shape, dtype=t.dtype, device=mesh.device))
        dist.broadcast(buf, owner, group=mesh.group)
        out[name] = buf
    return out


class _StageWhisper(M.Whisper):
    """The module tree a stage's ``functional_call`` runs over (no storage):
    ``forward(part, ...)`` runs one part of the pipelined model."""

    def forward(self, part: str, *args):
        if part == "stem":
            return self.encoder.stem(*args)
        if part == "encoder":
            return _encoder_blocks(self, *args)
        if part == "ln_post":
            return self.encoder.ln_post(*args)
        if part == "embed":
            return _embed(self, *args)
        if part == "decoder":
            return _decoder_blocks(self, *args)
        if part == "head":
            return self.logits(self.decoder.ln(*args))
        raise ValueError(part)


@functools.lru_cache(maxsize=4)
def _stage_skeleton(cfg: WhisperConfig) -> _StageWhisper:
    return _StageWhisper(cfg, device="meta")


def pp_loss_and_grads(params: dict, cfg: WhisperConfig, batch: dict, mesh: StageMesh,
                       n_micro: int):
    """(loss on every stage, this stage's gradients): one GPipe forward and
    backward of the plain step's loss."""
    skel = _stage_skeleton(cfg)
    s, last = mesh.rank, mesh.rank == mesh.stages - 1
    mel, tokens_in = batch["mel"], batch["tokens_in"]
    b, dev = mel.shape[0], mel.device
    lo_e, hi_e = _stage_range(cfg.n_audio_layer, mesh)
    lo_d, hi_d = _stage_range(cfg.n_text_layer, mesh)
    _microbatches(mel, n_micro)  # the divisibility check on every stage
    bm = b // n_micro
    dtype = params["decoder.pos_emb"].dtype

    def run(part, *args):
        return torch.func.functional_call(skel, params, (part,) + args, strict=False)

    for p in params.values():
        p.grad = None
    with exact_kernels():
        # encoder pipeline
        x = run("stem", mel) if s == 0 else None
        like_e = torch.empty(bm, mel.shape[1] // 2, cfg.n_audio_state, dtype=dtype, device=dev)
        enc_in, enc_out = _forward_stages(
            mesh, lambda m, h: checkpoint(run, "encoder", h, lo_e, hi_e, use_reentrant=False),
            None if x is None else _microbatches(x, n_micro), like_e, n_micro, grad=True)
        xa_last = run("ln_post", torch.cat(enc_out)) if last else None
        like_xa = torch.empty(b, mel.shape[1] // 2, cfg.n_audio_state, dtype=dtype, device=dev)
        xa = _broadcast_from_last(xa_last, like_xa, mesh).requires_grad_(True)
        xa_mb = _microbatches(xa, n_micro)

        # decoder pipeline
        t = tokens_in.shape[1]
        causal = _causal(t, dev)
        y0 = run("embed", tokens_in, dtype) if s == 0 else None
        like_d = torch.empty(bm, t, cfg.n_text_state, dtype=dtype, device=dev)
        dec_in, dec_out = _forward_stages(
            mesh, lambda m, h: checkpoint(run, "decoder", h, xa_mb[m], causal, lo_d, hi_d,
                                          use_reentrant=False),
            None if y0 is None else _microbatches(y0, n_micro), like_d, n_micro, grad=True)
        loss = None
        if last:
            loss = _masked_nll(run("head", torch.cat(dec_out)), batch["tokens_out"],
                               batch["mask"])
            torch.autograd.backward(loss)

        # backward: the decoder's stages, then xa's gradient onto the last
        # stage, then the encoder's stages
        _backward_stages(mesh, dec_in, dec_out)
        if s == 0:
            torch.autograd.backward(y0, torch.cat([h.grad for h in dec_in]))
        g_xa = C.all_reduce_sum(xa.grad, mesh.group)
        if last:
            torch.autograd.backward(xa_last, g_xa)
        _backward_stages(mesh, enc_in, enc_out)
        if s == 0:
            torch.autograd.backward(x, torch.cat([h.grad for h in enc_in]))

    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
    for p in params.values():
        p.grad = None
    _zero_frozen(grads)
    C.all_reduce_sum_([g for k, g in grads.items() if not _is_block(k)], mesh.group)
    like_loss = torch.zeros((), dtype=torch.float32, device=dev)
    return _broadcast_from_last(loss, like_loss, mesh), grads


def make_pp_train_step(cfg: WhisperConfig, mesh: StageMesh, n_micro: int, optimizer=None):
    """(train_step, shard_batch) with ``make_sharded_train_step``'s batch
    contract, the layers pipelined over the stages instead of dp × tp. The
    loss is the plain step's (``sum(nll·mask) / sum(mask)`` over the whole
    batch): the microbatches only reschedule it. ``shard_batch`` puts the
    whole batch on this stage's device."""
    optimizer = optimizer or O.adamw(1e-5)

    def train_step(state: TrainState, batch: dict):
        loss, grads = pp_loss_and_grads(state.params, cfg, batch, mesh, n_micro)
        grads = O.ShardedLeaves(grads, frozenset(k for k in grads if _is_block(k)), mesh.group)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        O.apply_updates(state.params, updates)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return train_step, functools.partial(_to_device, device=mesh.device)


def make_pp_train_state(cfg: WhisperConfig, generator: torch.Generator, mesh: StageMesh,
                        optimizer=None, dtype=torch.float32):
    """TrainState of this stage: the whole seeded init on the stage's
    device, then its entries (``pp_shard_params``), before
    ``optimizer.init``, so the moments are the stage's too."""
    optimizer = optimizer or O.adamw(1e-5)
    model = M.init_params(cfg, generator, dtype, mesh.device)
    state = pp_shard_params(model.state_dict(), cfg, mesh)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()}
    return TrainState(params, optimizer.init(params), 0), optimizer
