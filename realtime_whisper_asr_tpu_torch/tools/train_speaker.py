"""Train the speaker embedder on synthetic speakers and write its weights.

    python -m realtime_whisper_asr_tpu_torch.tools.train_speaker \\
        [--steps 600] [--corpus-speakers 160] [--corpus-utts 5] \\
        [--speakers-per-batch 24] [--utts-per-speaker 2] [--lr 3e-4] \\
        [--temp 0.1] [--seed 0] [--out PATH.npz] [--cpu]

Port of the JAX package's ``tools/train_speaker.py``: NT-Xent over batches
of P speakers x K utterances (a synthetic "speaker" is a fixed formant
anatomy and pitch register, ``models/vad/synthetic.sample_speaker``;
utterances vary phrase, contour and noise), drawn from a corpus of pooled
features synthesised once on the host (``batch_features``: the same numpy
draws as the JAX tool, so the corpus is bit-equal for a seed). The three
layers' forward and the loss run in torch on the card (``--cpu``: on the
CPU; without CUDA and without ``--cpu`` it raises), ``optim.adam(lr)``
(optax's arithmetic) from ``init_speaker_params(seed)``, the numpy
initialisation both packages share. Reports the held-out same-vs-different
cosine AUC and the equal-error threshold, which ships in the npz as the
tracker's default decision threshold. ``--out`` defaults to the port's
packaged ``models/weights/speaker_nn.npz``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def batch_features(rng: np.random.Generator, n_speakers: int, k: int,
                   snr_prob: float = 0.6) -> tuple[np.ndarray, np.ndarray]:
    """(features (n_speakers·k, FEAT_DIM) f32, labels int32): ``k``
    utterances of each of ``n_speakers`` fresh synthetic speakers."""
    from realtime_whisper_asr_tpu_torch.models.speaker import utterance_features
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import (
        sample_speaker,
        synth_speaker_utterance,
    )

    feats, labels = [], []
    for s in range(n_speakers):
        spk = sample_speaker(rng)
        for _ in range(k):
            snr = float(rng.uniform(5, 25)) if rng.random() < snr_prob else None
            sec = float(rng.uniform(1.2, 3.0))
            a = synth_speaker_utterance(rng, spk, seconds=sec, snr_db=snr)
            feats.append(utterance_features(a))
            labels.append(s)
    return np.stack(feats), np.asarray(labels, np.int32)


def auc_and_eer(sims: np.ndarray, same: np.ndarray) -> tuple[float, float]:
    """(rank-based ROC AUC, the threshold where the false-accept and
    false-reject rates are closest)."""
    order = np.argsort(sims)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(sims) + 1)
    pos = same > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    a = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    ths = np.unique(sims)
    best_th, best_gap = 0.5, 1e9
    for th in ths:
        far = float((sims[~pos] >= th).mean())
        frr = float((sims[pos] < th).mean())
        if abs(far - frr) < best_gap:
            best_gap, best_th = abs(far - frr), float(th)
    return float(a), best_th


def make_corpus(rng: np.random.Generator, n_speakers: int, n_utts: int) -> dict:
    """The training corpus, synthesised once (harmonic synthesis dominates
    the tool's time): normalised features ``x``, labels ``y``, the
    normalisation ``f_mu`` / ``f_sd`` and each speaker's rows."""
    x, y = batch_features(rng, n_speakers, n_utts)
    f_mu = x.mean(axis=0).astype(np.float32)
    f_sd = (x.std(axis=0) + 1e-6).astype(np.float32)
    return {"x": (x - f_mu) / f_sd, "y": y, "f_mu": f_mu, "f_sd": f_sd,
            "by_speaker": {s: np.flatnonzero(y == s) for s in np.unique(y)}}


def minibatch(rng: np.random.Generator, corpus: dict, speakers: int,
              utts: int) -> tuple[np.ndarray, np.ndarray]:
    """``speakers`` distinct speakers x ``utts`` of their utterances, drawn
    as the JAX tool draws them."""
    by_speaker = corpus["by_speaker"]
    spk_ids = rng.choice(len(by_speaker), size=speakers, replace=False)
    rows = np.concatenate([rng.choice(by_speaker[s], size=utts, replace=False)
                           for s in spk_ids])
    return corpus["x"][rows], corpus["y"][rows]


def embed(p: dict, x):
    """relu(x·w1 + b1), relu(·w2 + b2), ·w3 + b3, then L2-normalised with the
    norm held at 1e-9 or more: ``models.speaker.embed`` in torch."""
    import torch

    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    e = h @ p["w3"] + p["b3"]
    norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return e / torch.clamp(norm, min=1e-9)


def ntxent(p: dict, x, labels, temp):
    """The JAX tool's NT-Xent: cosine similarities over ``temp`` (a 0-d
    tensor: CUDA turns a division by a Python scalar into a multiply by its
    reciprocal), the diagonal set to -1e9, the mean over rows of the row's
    logsumexp less its positives' logsumexp."""
    import torch

    e = embed(p, x)
    sims = e @ e.T / temp
    n = x.shape[0]
    self_mask = torch.eye(n, dtype=torch.bool, device=x.device)
    pos = (labels[:, None] == labels[None, :]) & ~self_mask
    neg = torch.full((), -1e9, device=x.device)
    logits = torch.where(self_mask, neg, sims)
    logz = torch.logsumexp(logits, dim=1)
    pos_logz = torch.logsumexp(torch.where(pos, logits, neg), dim=1)
    return torch.mean(logz - pos_logz)


def init_params(seed: int, device) -> dict:
    """The trained leaves of ``init_speaker_params(seed)`` as f32 tensors."""
    import torch

    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.models.speaker import init_speaker_params

    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in init_speaker_params(seed).items()
            if k.startswith(("w", "b"))}


def make_train_step(optimizer, temp: float, device):
    """``step(params, opt_state, x, y) -> (opt_state, loss)``: the loss and
    its gradient under ``device.exact_kernels`` (IEEE f32 matmuls), the
    update applied in place."""
    import torch

    from realtime_whisper_asr_tpu_torch.device import exact_kernels, resolve_device
    from realtime_whisper_asr_tpu_torch.train import optim as O

    t = torch.full((), temp, dtype=torch.float32, device=resolve_device(device))

    def step(params: dict, opt_state, x, y):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        with exact_kernels():
            loss = ntxent(leaves, x, y, t)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        updates, opt_state = optimizer.update(dict(zip(leaves, grads)), opt_state, params)
        O.apply_updates(params, updates)
        return opt_state, loss.detach()

    return step


def train(corpus: dict, rng: np.random.Generator, steps: int, speakers: int, utts: int,
          lr: float, temp: float, seed: int, device, log_every: int = 50):
    """``steps`` Adam steps from ``init_speaker_params(seed)`` on minibatches
    drawn from ``rng`` -> (params as numpy, losses)."""
    import torch

    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.train import optim as O

    device = resolve_device(device)
    params = init_params(seed, device)
    opt = O.adam(lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(opt, temp, device)
    losses = []
    t0 = time.time()
    for step in range(1, steps + 1):
        xn, y = minibatch(rng, corpus, speakers, utts)
        opt_state, loss = step_fn(params, opt_state, torch.from_numpy(xn).to(device),
                                  torch.from_numpy(y).long().to(device))
        losses.append(loss)
        if step % log_every == 0 or step == 1:
            print(f"step {step} loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)
    return {k: v.cpu().numpy() for k, v in params.items()}, [float(x) for x in losses]


def heldout(np_params: dict, seed: int) -> tuple[float, float, float]:
    """(trained AUC, raw-feature baseline AUC, EER threshold) over all pairs
    of 40 fresh speakers x 3 utterances (``seed + 1000``)."""
    from realtime_whisper_asr_tpu_torch.models.speaker import embed as embed_np

    xs, ys = batch_features(np.random.default_rng(seed + 1000), 40, 3, snr_prob=0.5)
    e = embed_np(np_params, xs)
    sims, same = [], []
    for i in range(len(e)):
        for j in range(i + 1, len(e)):
            sims.append(float(np.dot(e[i], e[j])))
            same.append(1.0 if ys[i] == ys[j] else 0.0)
    sims, same = np.asarray(sims), np.asarray(same)
    a, th = auc_and_eer(sims, same)
    xr = (xs - np_params["f_mu"]) / np_params["f_sd"]
    xr = xr / np.maximum(np.linalg.norm(xr, axis=1, keepdims=True), 1e-9)
    sims_b = np.asarray([float(np.dot(xr[i], xr[j]))
                         for i in range(len(xr)) for j in range(i + 1, len(xr))])
    ab, _ = auc_and_eer(sims_b, same)
    return a, ab, th


def main(argv=None) -> int:
    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.models.speaker import _PACKAGED_WEIGHTS, SpeakerEmbedder

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--corpus-speakers", type=int, default=160)
    ap.add_argument("--corpus-utts", type=int, default=5)
    ap.add_argument("--speakers-per-batch", type=int, default=24)
    ap.add_argument("--utts-per-speaker", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temp", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=_PACKAGED_WEIGHTS)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    rng = np.random.default_rng(args.seed)
    t_gen = time.time()
    corpus = make_corpus(rng, args.corpus_speakers, args.corpus_utts)
    print(f"corpus: {len(corpus['x'])} utterances / {args.corpus_speakers} speakers "
          f"({time.time() - t_gen:.0f}s)")
    np_params, _ = train(corpus, rng, args.steps, args.speakers_per_batch,
                         args.utts_per_speaker, args.lr, args.temp, args.seed, device)
    np_params["f_mu"], np_params["f_sd"] = corpus["f_mu"], corpus["f_sd"]
    a, ab, th = heldout(np_params, args.seed)
    print(f"held-out speaker AUC: trained {a:.4f} vs raw-feature baseline {ab:.4f}; "
          f"EER threshold {th:.3f}")

    np_params["threshold"] = np.float32(th)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    SpeakerEmbedder(params=np_params).save_npz(out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
