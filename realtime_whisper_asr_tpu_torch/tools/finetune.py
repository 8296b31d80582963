"""End-to-end Whisper fine-tuning recipe on one CUDA card.

    python -m realtime_whisper_asr_tpu_torch.tools.finetune \\
        --manifest train.jsonl --model tiny --out /ckpts/run1 --epochs 2 \\
        --batch-size 8 --lr 1e-5 [--val-manifest val.jsonl] \\
        [--init-checkpoint DIR] [--resume] [--save-every 200] [--cpu]

Port of the JAX package's ``tools/finetune.py``, on one device: manifest →
bucketed data pipeline (``train/data.py``, each row's log-mel by the card's
kernel) → teacher-forced train step (``train/train_step.py``) → train-state
checkpoints with resume (``checkpoint.save_train_state``) → a native
inference checkpoint that ``TorchWhisperASR(checkpoint_dir=...)`` loads.
The same flags and recipe: ``clip_by_global_norm(1.0)`` then
``adamw(warmup_cosine_decay_schedule(0, lr, warmup, decay), weight_decay)``
(``train/optim.py``, optax's arithmetic), decay over ``--max-steps`` or
10,000 steps. ``--init-checkpoint`` takes the port's native format or an HF
directory. The card unless ``--cpu``; without CUDA and without ``--cpu`` it
raises. ``--mesh`` larger than 1x1, ``--sequence-parallel`` and
``--pipeline-stages`` exit with an error until the port's ``parallel``
package exists.

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
    ap.add_argument("--mesh", default=None,
                    help="DxT data x model mesh; only 1x1 until the parallel package is ported")
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="Megatron-SP (needs the parallel package: not ported yet)")
    ap.add_argument("--pipeline-stages", type=int, default=None,
                    help="GPipe stages (needs the parallel package: not ported yet)")
    ap.add_argument("--microbatches", type=int, default=2,
                    help="microbatches per step under --pipeline-stages")
    ap.add_argument("--save-every", type=int, default=500, help="steps between train-state saves")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the train state in --out if present")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card; raises without one)")
    return ap.parse_args(argv)


def _refuse_parallel(args) -> None:
    if args.pipeline_stages or args.sequence_parallel or (
            args.mesh and args.mesh.lower().replace(" ", "") != "1x1"):
        raise SystemExit("--mesh larger than 1x1, --sequence-parallel and --pipeline-stages "
                         "need the port's parallel package, which is not ported yet; this "
                         "tool trains on one device")


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
    from realtime_whisper_asr_tpu_torch.train import optim as O
    from realtime_whisper_asr_tpu_torch.train.data import DataPipeline, prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import (
        TrainState,
        eval_loss,
        make_train_state,
        make_train_step,
        trainable,
    )

    _refuse_parallel(args)
    device = resolve_device("cpu" if args.cpu else "cuda")

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
        state, optimizer = make_train_state(cfg, gen, optimizer=optimizer, device=device)
    else:
        params = trainable(params, device)
        state = TrainState(params, optimizer.init(params), 0)
    train_step, _ = make_train_step(cfg, optimizer, device=device)

    state_dir = os.path.join(args.out, "train_state")
    if args.resume and os.path.isdir(state_dir):
        state = load_train_state(state_dir, state)
        logger.info("resumed at step %d", state.step)

    # ---- data
    pipe = DataPipeline(args.manifest, cfg, tokenizer,
                        batch_size=args.batch_size, seed=args.seed)

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
        state, loss = train_step(state, prepare_batch(batch, cfg, device))
        losses.append(float(loss))
        step = state.step
        if step % args.log_every == 0:
            logger.info("step %d loss %.4f (%.2f steps/s)", step,
                        float(np.mean(losses[-args.log_every:])),
                        (step - step0) / max(time.time() - t0, 1e-6))
        if args.save_every and step % args.save_every == 0:
            save_train_state(state_dir, state)
            logger.info("saved train state at step %d", step)
        if args.max_steps and step - step0 >= args.max_steps:
            stop = True
            break
    final_loss = float(np.mean(losses[-20:])) if losses else float("nan")

    # ---- save: resumable train state + inference checkpoint
    save_train_state(state_dir, state)
    ckpt_dir = os.path.join(args.out, "checkpoint")
    save_checkpoint(ckpt_dir, state.params, cfg)
    logger.info("wrote inference checkpoint to %s (load with "
                "TorchWhisperASR(checkpoint_dir=...))", ckpt_dir)
    return {"losses": losses, "state": state, "cfg": cfg, "final_train_loss": final_loss,
            "val_loss": run_eval(state.params) if args.val_manifest else None,
            "steps": state.step, "stopped_early": stop}


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    out = finetune(args)
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
