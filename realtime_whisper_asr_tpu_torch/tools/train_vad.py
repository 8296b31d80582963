"""Train the Silero-class VAD on the synthetic corpus and write its weights.

    python -m realtime_whisper_asr_tpu_torch.tools.train_vad \\
        [--steps 1500] [--batch 16] [--seconds 4] [--lr 2e-3] [--seed 0] \\
        [--out PATH.npz] [--cpu]

Port of the JAX package's ``tools/train_vad.py``: BCE over per-frame labels
(synthetic speech/noise mixtures, ``models/vad/synthetic.py``) in optax's
``sigmoid_binary_cross_entropy`` form, ``optim.adam(lr)``, the network's
batched ``sequence_logits`` on the card (``--cpu``: on the CPU; without CUDA
and without ``--cpu`` it raises). Reports held-out AUC against the EnergyVAD
baseline and writes the npz in the JAX package's layout (``params_to_jax``),
which ``SileroLikeVAD`` loads. ``--out`` defaults to the port's packaged
weights file.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def make_batch(rng: np.random.Generator, batch: int, seconds: float):
    """(audio (B, T, 512) f32, labels (B, T) f32): ``batch`` synthetic
    examples of ``seconds`` each, framed."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import FRAME, synth_example

    n_frames = int(seconds * 16000) // FRAME
    audio = np.zeros((batch, n_frames, FRAME), np.float32)
    labels = np.zeros((batch, n_frames), np.float32)
    for b in range(batch):
        a, l = synth_example(rng, seconds)
        audio[b] = a[: n_frames * FRAME].reshape(n_frames, FRAME)
        labels[b] = l[:n_frames]
    return audio, labels


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC AUC (no sklearn dependency)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def eval_auc(prob_fn_factory, rng: np.random.Generator, n_clips: int = 24) -> float:
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import FRAME, synth_example

    scores, labels = [], []
    for _ in range(n_clips):
        a, l = synth_example(rng, 4.0)
        frames = a[: len(l) * FRAME].reshape(len(l), FRAME)
        vad = prob_fn_factory()
        scores.append(np.asarray(vad(frames), np.float64))
        labels.append(l)
    return auc(np.concatenate(scores), np.concatenate(labels))


def sigmoid_binary_cross_entropy(logits, labels):
    """optax's form: ``-y·log σ(x) - (1-y)·log σ(-x)``, log σ(x) =
    ``-logaddexp(-x, 0)`` as ``jax.nn.log_sigmoid``."""
    import torch

    zero = torch.zeros((), device=logits.device)
    log_p = -torch.logaddexp(-logits, zero)
    log_not_p = -torch.logaddexp(logits, zero)
    return -labels * log_p - (1.0 - labels) * log_not_p


def trainable_params(net) -> dict:
    """The parameters a step updates: all but ``lstm.bias_hh_l0``, which is
    frozen at 0 (the JAX tree has one LSTM bias)."""
    net.lstm.bias_hh_l0.requires_grad_(False)
    return {k: p for k, p in net.named_parameters() if p.requires_grad}


def make_train_step(net, optimizer):
    """``step(params, opt_state, audio, labels) -> (opt_state, loss)`` on
    the net's device: the mean BCE of ``net.sequence_logits``, its gradient
    under ``device.exact_kernels``, an optimizer update applied in place."""
    import torch

    from realtime_whisper_asr_tpu_torch.device import exact_kernels
    from realtime_whisper_asr_tpu_torch.train import optim as O

    def step(params: dict, opt_state, audio, labels):
        with exact_kernels():
            loss = sigmoid_binary_cross_entropy(net.sequence_logits(audio), labels).mean()
            grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
        O.apply_updates(params, updates)
        return opt_state, loss.detach()

    return step


def train(net, steps: int, batch: int, seconds: float, lr: float, seed: int,
          log_every: int = 100) -> list[float]:
    """``steps`` Adam steps of ``net`` (in place) on batches drawn from
    ``np.random.default_rng(seed)``, as the JAX tool draws them; returns the
    losses (read from the card at each logged step and at the end)."""
    import torch

    from realtime_whisper_asr_tpu_torch.train import optim as O

    params = trainable_params(net)
    opt = O.adam(lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(net, opt)
    dev = net.window.device
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.time()
    for step in range(steps):
        audio, labels = make_batch(rng, batch, seconds)
        opt_state, loss = step_fn(params, opt_state, torch.from_numpy(audio).to(dev),
                                  torch.from_numpy(labels).to(dev))
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)
    return [float(x) for x in losses]


def main(argv=None) -> int:
    from realtime_whisper_asr_tpu_torch.models.vad import silero_like as S

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=S._PACKAGED_WEIGHTS)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    net = S.SileroLikeNet(device, seed=args.seed)
    train(net, args.steps, args.batch, args.seconds, args.lr, args.seed)

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    params = S.params_to_jax(net.state_dict())
    np.savez(out, **params)
    print(f"wrote {out}")

    # held-out eval (fresh seed): trained model vs EnergyVAD
    from realtime_whisper_asr_tpu_torch.models.vad import EnergyVAD

    eval_rng = np.random.default_rng(args.seed + 10_000)
    trained = eval_auc(lambda: S.SileroLikeVAD(params=params, device=device), eval_rng)
    eval_rng = np.random.default_rng(args.seed + 10_000)
    energy = eval_auc(EnergyVAD, eval_rng)
    print(f"held-out AUC: silero_like={trained:.4f} energy={energy:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
