"""Train the neural vocal separator on synthetic speech + interference mixtures.

    python -m realtime_whisper_asr_tpu_torch.tools.train_separator \\
        [--steps 2500] [--batch 8] [--lr 1e-3] [--seed 0] \\
        [--arch v1|v2|v2s|v2x4] [--degrade-prob 0.0] [--ckpt-every 250] \\
        [--resume CKPT.npz] [--out PATH.npz] [--cpu]

Port of the JAX package's ``tools/train_separator.py``. The corpus is its
synthetic one, copied: reverberant speech (synthetic RIRs, RT60 0.1–0.45 s)
at an SNR of −10..15 dB under music beds, hum, tones, noise, percussion or
two of them at once (``make_batch``), and for ``v2x4`` the 4-stem mixtures
(vocals, drums, bass, other) with optional real-music degradations (codec,
compression, bleed, crowd). The same numpy generator gives the same batches
bit for bit. The target is the (reverberant) speech.

Loss: time-domain L1 + 0.5 · L1 of ``log1p(|STFT|)``, through the port's
``separate_vocals`` (1-stem nets) or ``separate_stems_device`` (stem nets)
under autograd, forward and backward inside ``device.exact_kernels`` (IEEE
f32 cuDNN convolutions, deterministic algorithms); ``optim.adam`` over
``optim.cosine_decay_schedule(lr, steps, alpha=0.05)`` (optax's
arithmetic). On the card unless ``--cpu``; without CUDA and without
``--cpu`` it raises.

``--ckpt-every`` writes, and ``--resume`` reads, the JAX tool's checkpoint
keys: ``p/<name>`` (HWIO kernels), ``o/<i>`` (optax's leaves of
``adam(schedule)``'s state: the adam count, ``mu``'s leaves by sorted name,
``nu``'s, the schedule count), ``step`` and ``rng`` (the numpy bit
generator's state as JSON), so a checkpoint of either tool resumes in the
other; a resumed run takes its architecture from the checkpoint. The
weights are written in the JAX layout (``params_to_jax``), which both
packages' ``NeuralSeparator.load_npz`` read. ``--out`` defaults to the
port's packaged ``models/weights/separation_nn.npz`` (a 4-stem net to the
port's ``VARIANT_WEIGHTS["4stem"]``). Reports the held-out SI-SNR
improvement per condition on the host mirror.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

SR = 16000
CLIP = 16384  # ~1 s @ 16 kHz, the smallest streaming bucket
CONDITIONS = ("music", "hum", "tone", "noise", "percussion", "dual")


def synth_percussion(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Kick/hat-style impulse train + noise bursts (a beat the chordal music
    bed lacks; broadband transients are the hardest masking case)."""
    n = int(seconds * SR)
    sig = np.zeros(n, np.float32)
    period = int(SR * rng.uniform(0.3, 0.6))
    t_dec = np.exp(-np.arange(2000) / rng.uniform(200, 600))
    for start in range(rng.integers(0, period), n, period):
        end = min(start + 2000, n)
        burst = rng.standard_normal(end - start).astype(np.float32) * t_dec[: end - start]
        f = rng.uniform(60, 120)
        thump = np.sin(2 * np.pi * f * np.arange(end - start) / SR) * t_dec[: end - start]
        sig[start:end] += burst * 0.5 + thump.astype(np.float32)
    peak = np.abs(sig).max() + 1e-9
    return sig / peak


def make_rir(rng: np.random.Generator, rt60: float) -> np.ndarray:
    """Exponentially decaying noise RIR (image-method surrogate)."""
    n = max(int(rt60 * SR), 64)
    h = rng.standard_normal(n).astype(np.float32)
    h *= np.exp(-3.0 * np.log(10) * np.arange(n) / n)
    h[0] = 1.0
    return h / (np.sqrt(np.sum(h**2)) + 1e-9)


def _interference(rng: np.random.Generator, cond: str, seconds: float) -> np.ndarray:
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_nonspeech

    if cond == "percussion":
        return synth_percussion(rng, seconds)
    if cond == "dual":
        a = _interference(rng, str(rng.choice(CONDITIONS[:5])), seconds)
        b = _interference(rng, str(rng.choice(CONDITIONS[:5])), seconds)
        out = a + b * rng.uniform(0.3, 1.0)
        return out / (np.abs(out).max() + 1e-9)
    # map named conditions onto synth_nonspeech kinds by rejection
    kind_of = {"noise": (0, 1), "hum": (2,), "tone": (3,), "music": (4,)}
    want = kind_of[cond]
    for _ in range(64):
        state = rng.integers(0, 2**31)
        r2 = np.random.default_rng(state)
        kind = int(np.random.default_rng(state).integers(0, 5))
        if kind in want:
            return synth_nonspeech(r2, seconds)
    return synth_nonspeech(rng, seconds)


def make_example(rng: np.random.Generator, cond: str | None = None,
                 snr_db: float | None = None, reverb: bool | None = None):
    """One (mix, target, condition); the target is the (possibly
    reverberant) speech."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech

    seconds = CLIP / SR
    cond = cond or str(np.random.default_rng(rng.integers(2**31)).choice(CONDITIONS))
    speech, _ = synth_speech(rng, seconds + 0.1)
    speech = speech[:CLIP]
    if reverb if reverb is not None else (rng.random() < 0.35):
        rir = make_rir(rng, rng.uniform(0.1, 0.45))
        speech = np.convolve(speech, rir)[:CLIP].astype(np.float32)
        speech /= np.abs(speech).max() + 1e-9
    noise = _interference(rng, cond, seconds + 0.1)[:CLIP]
    snr = snr_db if snr_db is not None else rng.uniform(-10.0, 15.0)
    sp = np.sqrt(np.mean(speech**2) + 1e-9)
    npow = np.sqrt(np.mean(noise**2) + 1e-9)
    g = (sp / npow) * 10 ** (-snr / 20)
    level = rng.uniform(0.1, 0.9)
    return (speech + g * noise) * level, speech * level, cond


def make_batch(rng: np.random.Generator, batch: int):
    mix = np.zeros((batch, CLIP), np.float32)
    clean = np.zeros((batch, CLIP), np.float32)
    for b in range(batch):
        mix[b], clean[b], _ = make_example(rng)
    return mix, clean


# ---------------------------------------------------------------- 4-stem corpus
# stem order matches separation_nn.STEM_NAMES


def synth_bass(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Low-register note line (40–180 Hz fundamentals + one octave), the
    spectral band the drums' thumps overlap: the hard pair to split."""
    n = int(seconds * SR)
    sig = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        dur = min(int(SR * rng.uniform(0.25, 0.8)), n - pos)
        f = rng.uniform(40, 180)
        t = np.arange(dur) / SR
        note = np.sin(2 * np.pi * f * t) + 0.3 * np.sin(2 * np.pi * 2 * f * t)
        env = np.exp(-np.arange(dur) / (SR * rng.uniform(0.15, 0.5)))
        sig[pos : pos + dur] += (note * env).astype(np.float32)
        pos += dur
    return sig / (np.abs(sig).max() + 1e-9)


def make_example_4stem(rng: np.random.Generator, degradation: str | None = None):
    """(mix, stems (4, CLIP)) with random per-stem gains and dropout (the
    softmax mask net must learn both separation and absence); the mixture
    optionally passed through one of ``DEGRADATIONS``."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech

    seconds = CLIP / SR
    vocals, _ = synth_speech(rng, seconds + 0.1)
    vocals = vocals[:CLIP]
    if rng.random() < 0.3:
        rir = make_rir(rng, rng.uniform(0.1, 0.4))
        vocals = np.convolve(vocals, rir)[:CLIP].astype(np.float32)
        vocals /= np.abs(vocals).max() + 1e-9
    raw = [
        vocals,
        synth_percussion(rng, seconds),
        synth_bass(rng, seconds),
        _interference(rng, "music", seconds + 0.1)[:CLIP],
    ]
    stems = np.zeros((4, CLIP), np.float32)
    for i, s in enumerate(raw):
        s = np.asarray(s[:CLIP], np.float32)
        rms = np.sqrt(np.mean(s**2) + 1e-9)
        present = rng.random() < (0.95 if i == 0 else 0.75)
        gain_db = rng.uniform(-9.0, 3.0) if i else 0.0
        if present:
            stems[i] = s / rms * 10 ** (gain_db / 20)
    level = rng.uniform(0.02, 0.15)
    stems *= level
    mix = stems.sum(axis=0)
    if degradation is not None:
        mix, stems = apply_degradation(rng, degradation, mix, stems)
    return mix, stems


def make_batch_4stem(rng: np.random.Generator, batch: int, degrade_prob: float = 0.0):
    mix = np.zeros((batch, CLIP), np.float32)
    stems = np.zeros((batch, 4, CLIP), np.float32)
    for b in range(batch):
        deg = None
        if degrade_prob and rng.random() < degrade_prob:
            deg = str(rng.choice(DEGRADATIONS[1:]))
        mix[b], stems[b] = make_example_4stem(rng, degradation=deg)
    return mix, stems


# ------------------------------------------------------ real-music degradations
# Each transforms the MIXTURE the net sees; the targets stay the clean stems,
# except under compression, whose time-varying gain applies to the targets too
# (a separator is not scored on undoing a mastering gain ride).

DEGRADATIONS = ("clean", "codec", "compress", "bleed", "crowd")


def degrade_codec(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Lossy-codec surrogate: per-frame spectral hole punching (only the
    strongest 8–25 % of bins kept), a hard 5.5–7.8 kHz band limit, and an
    8–11-bit PCM re-quantization."""
    n = len(x)
    frame, hop = 512, 256
    win = np.hanning(frame).astype(np.float32)
    pad = np.concatenate([x, np.zeros(frame, np.float32)])
    out = np.zeros(n + frame, np.float32)
    wsum = np.zeros(n + frame, np.float32)
    keep = rng.uniform(0.08, 0.25)
    cut_bin = int(rng.uniform(5500.0, 7800.0) / (SR / frame))
    for i in range(0, n, hop):
        seg = pad[i : i + frame] * win
        S = np.fft.rfft(seg)
        mag = np.abs(S)
        S[mag < np.quantile(mag, 1.0 - keep)] = 0
        S[cut_bin:] = 0
        out[i : i + frame] += np.fft.irfft(S).astype(np.float32) * win
        wsum[i : i + frame] += win * win
    y = out[:n] / np.maximum(wsum[:n], 1e-3)
    q = 2.0 ** (1 - int(rng.integers(8, 12)))
    peak = np.abs(y).max() + 1e-9
    return (np.round(y / peak / q) * q * peak).astype(np.float32)


def compress_gain(rng: np.random.Generator, mix: np.ndarray) -> np.ndarray:
    """Loudness-war gain trajectory: a one-pole envelope follower (30–150
    ms), a 4–10:1 ratio above a program-dependent threshold."""
    from scipy.signal import lfilter

    a = np.exp(-1.0 / (rng.uniform(0.03, 0.15) * SR))
    env = lfilter([1.0 - a], [1.0, -a], np.abs(mix)).astype(np.float32)
    thresh = float(np.quantile(env, rng.uniform(0.3, 0.6))) + 1e-6
    ratio = rng.uniform(4.0, 10.0)
    gain = np.ones_like(env)
    over = env > thresh
    gain[over] = (thresh / env[over]) ** (1.0 - 1.0 / ratio)
    return gain


def degrade_bleed(rng: np.random.Generator, mix: np.ndarray, stems: np.ndarray) -> np.ndarray:
    """Stereo-bleed-to-mono surrogate: each stem leaks a 4–15 ms delayed,
    lowpassed copy into the downmix."""
    y = mix.copy()
    for s in stems:
        if np.sqrt(np.mean(s**2)) < 1e-6:
            continue
        d = int(rng.uniform(0.004, 0.015) * SR)
        leaked = np.zeros_like(s)
        leaked[d:] = s[:-d]
        leaked = np.convolve(leaked, np.ones(8, np.float32) / 8.0, mode="same")
        y += rng.uniform(0.1, 0.3) * leaked
    return y.astype(np.float32)


def crowd_babble(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """6–10 overlapping speech-like voices (a live recording's crowd bed),
    adversarial for a vocals mask because it is speech-shaped."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech

    n = int(seconds * SR)
    out = np.zeros(n, np.float32)
    for _ in range(int(rng.integers(6, 11))):
        v, _ = synth_speech(rng, seconds + 0.05)
        g = rng.uniform(0.2, 1.0)
        off = int(rng.integers(0, max(1, n // 4)))
        seg = v[: n - off]
        out[off : off + len(seg)] += g * seg
    return out / (np.abs(out).max() + 1e-9)


def apply_degradation(rng: np.random.Generator, deg: str, mix: np.ndarray,
                      stems: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mix', stems') under the named degradation (see ``DEGRADATIONS``)."""
    if deg == "clean":
        return mix, stems
    if deg == "codec":
        return degrade_codec(rng, mix), stems
    if deg == "compress":
        g = compress_gain(rng, mix)
        return (mix * g).astype(np.float32), (stems * g).astype(np.float32)
    if deg == "bleed":
        return degrade_bleed(rng, mix, stems), stems
    if deg == "crowd":
        bed = crowd_babble(rng, len(mix) / SR)[: len(mix)]
        rms = np.sqrt(np.mean(mix**2) + 1e-9)
        return (mix + bed * rms * rng.uniform(0.15, 0.5)).astype(np.float32), stems
    raise ValueError(f"unknown degradation {deg!r}")


# ------------------------------------------------------------------- evaluation


def si_snr(est: np.ndarray, ref: np.ndarray) -> float:
    ref = ref - ref.mean()
    est = est - est.mean()
    s = (np.dot(est, ref) / (np.dot(ref, ref) + 1e-9)) * ref
    e = est - s
    return float(10 * np.log10((np.dot(s, s) + 1e-9) / (np.dot(e, e) + 1e-9)))


def evaluate(sep, seed: int, per_cond: int = 8) -> dict:
    """Held-out SI-SNR improvement by condition (and overall). Each
    condition's generator is seeded by ``zlib.crc32`` of its name (``hash``
    is salted per process)."""
    out = {}
    gains_all = []
    for cond in CONDITIONS:
        rng = np.random.default_rng((seed, zlib.crc32(cond.encode())))
        gains = []
        for _ in range(per_cond):
            mix, clean, _ = make_example(rng, cond=cond)
            est = sep.separate(mix)
            gains.append(si_snr(est, clean) - si_snr(mix, clean))
        out[cond] = round(float(np.mean(gains)), 2)
        gains_all += gains
    out["overall"] = round(float(np.mean(gains_all)), 2)
    return out


def evaluate_4stem(sep, seed: int, n: int = 24) -> dict:
    """Held-out per-stem SI-SNR improvement over the mixture baseline."""
    from realtime_whisper_asr_tpu_torch.models.separation_nn import STEM_NAMES

    rng = np.random.default_rng((seed, zlib.crc32(b"4stem")))
    gains = {name: [] for name in STEM_NAMES}
    for _ in range(n):
        mix, stems = make_example_4stem(rng)
        est = sep.separate_stems(mix)
        for i, name in enumerate(STEM_NAMES):
            if np.sqrt(np.mean(stems[i] ** 2)) < 1e-6:
                continue  # stem absent in this example
            gains[name].append(si_snr(est[name], stems[i]) - si_snr(mix, stems[i]))
    return {name: round(float(np.mean(g)), 2) for name, g in gains.items() if g}


def evaluate_4stem_conditions(sep, seed: int, n: int = 16) -> dict:
    """Per-degradation x per-stem SI-SNR improvement table."""
    from realtime_whisper_asr_tpu_torch.models.separation_nn import STEM_NAMES

    table: dict = {}
    for deg in DEGRADATIONS:
        rng = np.random.default_rng((seed, zlib.crc32(deg.encode())))
        gains = {name: [] for name in STEM_NAMES}
        for _ in range(n):
            mix, stems = make_example_4stem(rng, degradation=deg)
            est = sep.separate_stems(mix)
            for i, name in enumerate(STEM_NAMES):
                if np.sqrt(np.mean(stems[i] ** 2)) < 1e-6:
                    continue
                gains[name].append(si_snr(est[name], stems[i]) - si_snr(mix, stems[i]))
        table[deg] = {name: round(float(np.mean(g)), 2) for name, g in gains.items() if g}
    return table


# --------------------------------------------------------------------- training


def init_params(arch: str, seed: int, device) -> dict:
    """The fresh net of ``arch`` in the port's layout (``torch.randn`` from
    a generator seeded with ``seed``)."""
    import torch

    from realtime_whisper_asr_tpu_torch.models import separation_nn as S

    gen = torch.Generator().manual_seed(seed)
    if arch == "v1":
        return S.init_separator_params(gen, device=device)
    if arch == "v2s":
        return S.init_separator_params_v2(gen, channels=S.V2_SMALL_CHANNELS, device=device)
    return S.init_separator_params_v2(gen, n_stems=4 if arch == "v2x4" else 1, device=device)


def make_optimizer(lr: float, steps: int):
    from realtime_whisper_asr_tpu_torch.train import optim as O

    return O.adam(O.cosine_decay_schedule(lr, steps, alpha=0.05))


def loss_fn(params: dict, mix, clean, dil):
    """Time-domain L1 + 0.5 · L1 of ``log1p(|STFT|)`` between the estimate
    and ``clean``: (B, N) for a 1-stem net, (B, C, N) for a stem net."""
    import torch

    from realtime_whisper_asr_tpu_torch.models import separation_nn as S

    if S.n_stems_of(params) > 1:
        est = torch.stack([S.separate_stems_device(params, row, dil=dil) for row in mix])
    else:
        est = S.separate_vocals(params, mix, dil=dil)
    l_time = torch.mean(torch.abs(est - clean))
    mag_e, mag_c = torch.log1p(S._stft(est).abs()), torch.log1p(S._stft(clean).abs())
    return l_time + 0.5 * torch.mean(torch.abs(mag_e - mag_c))


def make_train_step(optimizer, dil):
    """``step(params, opt_state, mix, clean) -> (opt_state, loss)``: the loss
    and its gradient inside ``device.exact_kernels``, the update applied in
    place."""
    import torch

    from realtime_whisper_asr_tpu_torch.device import exact_kernels
    from realtime_whisper_asr_tpu_torch.train import optim as O

    def step(params: dict, opt_state, mix, clean):
        for v in params.values():
            v.requires_grad_(True)
        with exact_kernels():
            loss = loss_fn(params, mix, clean, dil)
            grads = torch.autograd.grad(loss, list(params.values()))
        for v in params.values():
            v.requires_grad_(False)
        updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state, params)
        O.apply_updates(params, updates)
        return opt_state, loss.detach()

    return step


def next_batch(rng: np.random.Generator, n_stems: int, batch: int, degrade_prob: float):
    return (make_batch_4stem(rng, batch, degrade_prob=degrade_prob) if n_stems > 1
            else make_batch(rng, batch))


def save_ckpt(path: str, params: dict, opt_state, step: int, rng: np.random.Generator) -> None:
    """The JAX tool's checkpoint of (params, adam(schedule)'s state, step,
    rng), written atomically."""
    from realtime_whisper_asr_tpu_torch.models.separation_nn import params_to_jax

    adam, sched = opt_state
    blob = {f"p/{k}": v for k, v in params_to_jax(params).items()}
    names = sorted(params)
    mu, nu = params_to_jax(adam.mu), params_to_jax(adam.nu)
    leaves = ([np.asarray(adam.count, np.int32)] + [mu[k] for k in names]
              + [nu[k] for k in names] + [np.asarray(sched.count, np.int32)])
    for i, leaf in enumerate(leaves):
        blob[f"o/{i}"] = leaf
    blob["step"] = np.asarray(step)
    blob["rng"] = np.asarray(json.dumps(rng.bit_generator.state))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **blob)
    os.replace(tmp, path)


def load_ckpt(path: str, optimizer, device):
    """A checkpoint of either tool -> (params in the port's layout on
    ``device``, the optimizer's state, step, rng)."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.separation_nn import params_from_jax

    ck = np.load(path, allow_pickle=False)
    params = params_from_jax({k[2:]: ck[k] for k in ck.files if k.startswith("p/")}, device)
    adam, sched = optimizer.init(params)
    names = sorted(params)
    n = len(names)
    if sum(k.startswith("o/") for k in ck.files) != 2 * n + 2:
        raise ValueError(f"{path}: optimizer leaves do not match adam(schedule) over {n} params")
    moments = params_from_jax({f"{which}{k}": ck[f"o/{1 + j * n + i}"]
                               for j, which in enumerate(("mu.", "nu."))
                               for i, k in enumerate(names)}, device)
    with torch.no_grad():
        for k in names:
            adam.mu[k].copy_(moments["mu." + k])
            adam.nu[k].copy_(moments["nu." + k])
    adam.count, sched.count = int(ck["o/0"]), int(ck[f"o/{2 * n + 1}"])
    rng = np.random.default_rng()
    rng.bit_generator.state = json.loads(str(ck["rng"]))
    return params, (adam, sched), int(ck["step"]), rng


def train(params: dict, optimizer, opt_state, rng: np.random.Generator, start_step: int,
          steps: int, batch: int, degrade_prob: float = 0.0, ckpt_every: int = 0,
          ckpt_path: str | None = None, log_every: int = 100):
    """Steps ``start_step`` .. ``steps - 1`` on batches drawn from ``rng``,
    ``params`` updated in place, a checkpoint every ``ckpt_every`` steps ->
    (optimizer state, losses)."""
    import torch

    from realtime_whisper_asr_tpu_torch.models import separation_nn as S

    dil, _ = S.arch_of(params)
    n_stems = S.n_stems_of(params)
    dev = next(iter(params.values())).device
    step_fn = make_train_step(optimizer, dil)
    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        mix, clean = next_batch(rng, n_stems, batch, degrade_prob)
        opt_state, loss = step_fn(params, opt_state, torch.from_numpy(mix).to(dev),
                                  torch.from_numpy(clean).to(dev))
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {float(loss):.5f} ({time.time() - t0:.0f}s)", flush=True)
        if ckpt_every and step and step % ckpt_every == 0:
            save_ckpt(ckpt_path, params, opt_state, step + 1, rng)
    return opt_state, [float(x) for x in losses]


def main(argv=None) -> int:
    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.models import separation_nn as S

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", choices=["v1", "v2", "v2s", "v2x4"], default="v2",
                    help="v2s = the 'small' packaged variant (same dilated receptive field, "
                         "~2.6x fewer MACs); v2x4 = the 4-stem softmax head")
    ap.add_argument("--degrade-prob", type=float, default=0.0,
                    help="fraction of 4-stem training mixtures passed through a random "
                         "real-music degradation (codec/compress/bleed/crowd)")
    ap.add_argument("--ckpt-every", type=int, default=250,
                    help="save params + optimizer state every N steps (crash resume)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint .npz written by --ckpt-every (either tool's) to resume from")
    ap.add_argument("--out", default=S._PACKAGED_WEIGHTS)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    opt = make_optimizer(args.lr, args.steps)
    if args.resume:
        # the architecture (and so the dilations and the optimizer's leaves)
        # comes from the checkpoint, not from --arch
        params, opt_state, start_step, rng = load_ckpt(args.resume, opt, device)
        print(f"resumed from {args.resume} at step {start_step}", flush=True)
    else:
        params = init_params(args.arch, args.seed, device)
        opt_state, start_step, rng = opt.init(params), 0, np.random.default_rng(args.seed)

    n_stems = S.n_stems_of(params)
    if n_stems > 1 and os.path.abspath(args.out) == os.path.abspath(S._PACKAGED_WEIGHTS):
        # don't clobber the packaged 2-stem frontend weights with a 4-stem net
        args.out = S.VARIANT_WEIGHTS["4stem"]
        print(f"--arch v2x4 with default --out: writing {args.out}", flush=True)
    out = os.path.abspath(args.out)
    train(params, opt, opt_state, rng, start_step, args.steps, args.batch, args.degrade_prob,
          args.ckpt_every, out + ".ckpt.npz")

    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **S.params_to_jax(params))
    print(f"wrote {out}")

    sep = S.NeuralSeparator.load_npz(out, use_device=False)
    if n_stems > 1:
        print("held-out per-stem SI-SNR improvement (dB):")
        print(json.dumps(evaluate_4stem(sep, seed=args.seed + 10_000), indent=1))
        print("per-degradation per-stem SI-SNR improvement (dB):")
        print(json.dumps(evaluate_4stem_conditions(sep, seed=args.seed + 10_000), indent=1))
        # the vocals stem doubles as the ASR frontend: scored on the 2-stem
        # hard corpus the packaged default is held to
        print("vocals-as-frontend SI-SNR improvement by condition (dB):")
    else:
        print("held-out SI-SNR improvement by condition (dB):")
    print(json.dumps(evaluate(sep, seed=args.seed + 10_000), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
