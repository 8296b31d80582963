"""End-to-end Whisper fine-tuning recipe on CUDA cards: one, or a mesh of them.

    python -m realtime_whisper_asr_tpu_torch.tools.finetune \\
        --manifest train.jsonl --model tiny --out /ckpts/run1 --epochs 2 \\
        --batch-size 8 --lr 1e-5 [--val-manifest val.jsonl] \\
        [--init-checkpoint DIR] [--resume] [--save-every 200] [--cpu]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m realtime_whisper_asr_tpu_torch.tools.finetune ... --mesh 2x2 \\
        [--sequence-parallel]       # or --pipeline-stages 4 --microbatches 2

Port of the JAX package's ``tools/finetune.py``: manifest → bucketed data
pipeline (``train/data.py``, each row's log-mel by the card's kernel) →
teacher-forced train step (``train/train_step.py``) → train-state
checkpoints with resume (``checkpoint.save_train_state``) → a native
inference checkpoint that ``TorchWhisperASR(checkpoint_dir=...)`` loads.
The same flags and recipe: ``clip_by_global_norm(1.0)`` then
``adamw(warmup_cosine_decay_schedule(0, lr, warmup, decay), weight_decay)``
(``train/optim.py``, optax's arithmetic), decay over ``--max-steps`` or
10,000 steps. ``--init-checkpoint`` takes the port's native format or an HF
directory. The card unless ``--cpu``; without CUDA and without ``--cpu`` it
raises.

``--mesh DxT`` (the dp × tp step, ``--sequence-parallel`` inside it) and
``--pipeline-stages S`` (GPipe, ``--microbatches`` a step) run one rank a
process, started by ``torch.distributed.run`` (NCCL on the cards, gloo
with ``--cpu``); a process not started so is a world of one. A mesh or a
stage count the world cannot run exits with the JAX tool's message. Every
rank writes its shard of the train state; rank 0 alone logs, writes the
final checkpoint (the shards gathered) and prints the result line.

The manifest is JSONL: {"wav": path, "text": str, "language"?: str} per line
(train/data.py). WAVs must be 16 kHz mono (io.read_wav). Prints one JSON
line: the final train loss (the mean of the last 20 steps), the validation
loss with ``--val-manifest``, the step count.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

logger = logging.getLogger("finetune")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--val-manifest", default=None)
    ap.add_argument("--model", default="tiny", help="config name (tiny..large-v3, test-tiny)")
    ap.add_argument("--init-checkpoint", default=None,
                    help="native or HF checkpoint dir to start from (else random init)")
    ap.add_argument("--out", required=True, help="output dir (train state + final checkpoint)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--warmup-steps", type=int, default=50)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--mesh", default=None, help="DxT data x model mesh, e.g. 2x4")
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="Megatron-SP: shard per-layer activations along the sequence over the "
                         "model axis (tp x less activation memory; numerically the same step)")
    ap.add_argument("--pipeline-stages", type=int, default=None,
                    help="GPipe pipeline parallelism: split the layer stacks across N stage "
                         "ranks (layer counts must divide by N; mutually exclusive with "
                         "--mesh/--sequence-parallel)")
    ap.add_argument("--microbatches", type=int, default=2,
                    help="microbatches per step under --pipeline-stages (batch-size must "
                         "divide evenly)")
    ap.add_argument("--save-every", type=int, default=500, help="steps between train-state saves")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the train state in --out if present")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card; raises without one)")
    return ap.parse_args(argv)


def _world_size() -> int:
    """The world this process belongs to: torchrun's, else a world of one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _plan_parallel(args):
    """(kind, shape) of the run: ("single", None), ("mesh", (D, T)) or
    ("pipeline", S); exits for what the world cannot run (the JAX tool's
    messages)."""
    pp = args.pipeline_stages
    if pp:
        if args.mesh or args.sequence_parallel:
            raise SystemExit("--pipeline-stages is mutually exclusive with "
                             "--mesh / --sequence-parallel")
        if args.batch_size % args.microbatches:
            raise SystemExit(f"--batch-size {args.batch_size} must divide by "
                             f"--microbatches {args.microbatches}")
        if _world_size() != pp:
            raise SystemExit(f"--pipeline-stages {pp} needs {pp} devices, have {_world_size()}")
        return "pipeline", pp
    if not (args.mesh or args.sequence_parallel):
        return "single", None
    d, t = (int(x) for x in (args.mesh or "1x1").lower().split("x"))
    if _world_size() != d * t:
        raise SystemExit(f"mesh {d}x{t} needs {d * t} devices, have {_world_size()}")
    return "mesh", (d, t)


def _join_world(device: str):
    """Join torchrun's process group, or make a world of this process alone."""
    import torch.distributed as dist

    from realtime_whisper_asr_tpu_torch.parallel import init_distributed

    if "RANK" in os.environ:
        init_distributed(device)
    else:
        init_distributed(device, store=dist.HashStore(), rank=0, world_size=1)
    return dist


def finetune(args: argparse.Namespace) -> dict:
    """Run the recipe; returns {"losses", "state", "cfg", "final_train_loss",
    "val_loss" (or None), "steps", "stopped_early"}."""
    import numpy as np
    import torch

    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.models.whisper import get_config, load_checkpoint_dir
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
        is_native_checkpoint,
        load_checkpoint,
        load_train_state,
        save_checkpoint,
        save_train_state,
    )
    from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import get_tokenizer
    from realtime_whisper_asr_tpu_torch.parallel import pipeline as P
    from realtime_whisper_asr_tpu_torch.parallel import sharding as S
    from realtime_whisper_asr_tpu_torch.train import optim as O
    from realtime_whisper_asr_tpu_torch.train.data import DataPipeline, prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import (
        TrainState,
        eval_loss,
        make_sharded_train_step,
        make_train_state,
        make_train_step,
        trainable,
    )

    kind, shape = _plan_parallel(args)
    mesh = dist = None
    if kind == "single":
        device = resolve_device("cpu" if args.cpu else "cuda")
    else:
        from realtime_whisper_asr_tpu_torch.parallel import make_mesh, make_pp_mesh

        dist = _join_world("cpu" if args.cpu else "cuda")
        mesh = make_pp_mesh(shape) if kind == "pipeline" else make_mesh(model_parallel=shape[1])
        device = mesh.device
        if mesh.rank:
            logger.setLevel(logging.WARNING)
        logger.info("%s %s on %s (%s)", kind, mesh.shape, device, dist.get_backend())
    rank0 = mesh is None or mesh.rank == 0

    # ---- model init
    if args.init_checkpoint:
        if is_native_checkpoint(args.init_checkpoint):
            cfg, params = load_checkpoint(args.init_checkpoint, torch.float32)
        else:
            cfg, params = load_checkpoint_dir(args.init_checkpoint, torch.float32)
        logger.info("initialized %s from %s", cfg.name, args.init_checkpoint)
    else:
        cfg = get_config(args.model)
        params = None
        logger.info("random-initializing %s", cfg.name)
    tokenizer = get_tokenizer(cfg, args.init_checkpoint)

    schedule = O.warmup_cosine_decay_schedule(
        0.0, args.lr, args.warmup_steps,
        decay_steps=max(args.max_steps or 10_000, args.warmup_steps + 1),
    )
    optimizer = O.chain(
        O.clip_by_global_norm(1.0),
        O.adamw(schedule, weight_decay=args.weight_decay),
    )
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        if kind == "pipeline":
            state, optimizer = P.make_pp_train_state(cfg, gen, mesh, optimizer)
        else:
            state, optimizer = make_train_state(cfg, gen, optimizer=optimizer, device=device,
                                                mesh=mesh)
    else:
        if kind == "mesh":
            params = S.shard_params(params, mesh)
        elif kind == "pipeline":
            params = P.pp_shard_params(params, cfg, mesh)
        params = trainable(params, device)
        state = TrainState(params, optimizer.init(params), 0)
    shard_fn = None
    if kind == "single":
        train_step, _ = make_train_step(cfg, optimizer, device=device)
    elif kind == "mesh":
        train_step, _ = make_sharded_train_step(cfg, mesh, optimizer,
                                                sequence_parallel=args.sequence_parallel)
        shard_fn = S.data_sharding(mesh)
    else:
        train_step, _ = P.make_pp_train_step(cfg, mesh, args.microbatches, optimizer)

    state_dir = os.path.join(args.out, "train_state")
    if args.resume and os.path.isdir(state_dir):
        state = load_train_state(state_dir, state, mesh)
        logger.info("resumed at step %d", state.step)

    # ---- data
    pipe = DataPipeline(args.manifest, cfg, tokenizer,
                        batch_size=args.batch_size, seed=args.seed)
    # dp needs B % data == 0, pp B % microbatches == 0: both hold only for
    # full batches, so stragglers are dropped when either is sharded
    pipe.drop_last = (kind == "mesh" and shape[0] > 1) or kind == "pipeline"

    def run_eval(params) -> float:
        vp = DataPipeline(args.val_manifest, cfg, tokenizer,
                          batch_size=args.batch_size, seed=1)
        tot, n = 0.0, 0
        for batch in vp.epochs(1):
            tot += float(eval_loss(params, cfg, prepare_batch(batch, cfg, device)))
            n += 1
        return tot / max(n, 1)

    # ---- loop
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    losses: list[float] = []
    step0 = state.step
    stop = False
    for batch in pipe.epochs(args.epochs):
        state, loss = train_step(state, prepare_batch(batch, cfg, device, shard_fn=shard_fn))
        losses.append(float(loss))
        step = state.step
        if step % args.log_every == 0:
            logger.info("step %d loss %.4f (%.2f steps/s)", step,
                        float(np.mean(losses[-args.log_every:])),
                        (step - step0) / max(time.time() - t0, 1e-6))
        if args.save_every and step % args.save_every == 0:
            save_train_state(state_dir, state, mesh)
            logger.info("saved train state at step %d", step)
        if args.max_steps and step - step0 >= args.max_steps:
            stop = True
            break
    final_loss = float(np.mean(losses[-20:])) if losses else float("nan")

    # ---- save: resumable train state + inference checkpoint (rank 0)
    save_train_state(state_dir, state, mesh)
    if kind == "mesh":
        params = S.gather_params(state.params, mesh)
    elif kind == "pipeline":
        params = P.pp_gather_params(state.params, cfg, mesh)
    else:
        params = state.params
    ckpt_dir = os.path.join(args.out, "checkpoint")
    val_loss = None
    if rank0:
        save_checkpoint(ckpt_dir, params, cfg)
        logger.info("wrote inference checkpoint to %s (load with "
                    "TorchWhisperASR(checkpoint_dir=...))", ckpt_dir)
        val_loss = run_eval(params) if args.val_manifest else None
    if dist is not None:
        dist.destroy_process_group()
    return {"losses": losses, "state": state, "cfg": cfg, "final_train_loss": final_loss,
            "val_loss": val_loss, "steps": state.step, "stopped_early": stop, "rank0": rank0}


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    out = finetune(args)
    if not out["rank0"]:
        return 0
    line = {"final_train_loss": round(out["final_train_loss"], 4)}
    if out["val_loss"] is not None:
        logger.info("validation loss: %.4f", out["val_loss"])
        line.update(val_loss=round(out["val_loss"], 4), steps=out["steps"],
                    stopped_early=out["stopped_early"])
    else:
        line["steps"] = out["steps"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
