"""Speech traffic for the benchmark: utterances and pauses drawn from the seed.

The audio is the port's VAD-training surrogate (the harmonic and formant
speech of ``models/vad/synthetic.synth_speech``), copied here so that the
yardstick stays fixed whatever the program later does to its own copy: a
pitch random walk of 85-255 Hz, 29 harmonics shaped by three formants and a
2-6 Hz syllabic envelope. One utterance is one burst of that envelope over
its whole length (the surrogate's inner pauses would let the VAD split it).

Every seed draws the same multiset of utterance and pause lengths: the
lognormal's and the uniform's quantiles at fixed probabilities, in an order
the seed shuffles. So seeds change which utterance falls where, not how much
speech a stream holds. The harmonics are summed with torch, on the card in a
run (the host's numpy would take seconds of set-up for many streams).
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np
import torch

SR = 16000
#: harmonics of the surrogate, and its formant bandwidth in Hz
N_HARMONICS = 29
FORMANT_BW = 280.0
#: ramp at each end of an utterance, in samples
RAMP = 400


@dataclasses.dataclass(frozen=True)
class UtteranceMix:
    """Utterance and pause lengths of a traffic mix, in seconds."""

    median_s: float
    sigma: float
    min_s: float
    max_s: float
    pause_min_s: float
    pause_max_s: float
    strata: int = 16

    @classmethod
    def from_dict(cls, d: dict) -> "UtteranceMix":
        return cls(float(d["utterance_median_s"]), float(d["utterance_sigma"]),
                   float(d["utterance_min_s"]), float(d["utterance_max_s"]),
                   float(d["pause_min_s"]), float(d["pause_max_s"]),
                   int(d.get("strata", 16)))

    def lengths(self) -> tuple[list[float], list[float]]:
        """The fixed utterance and pause lengths: the clipped lognormal's and
        the uniform's quantiles at (i + 1/2) / strata."""
        probs = [(i + 0.5) / self.strata for i in range(self.strata)]
        norm = statistics.NormalDist()
        utts = [min(self.max_s, max(self.min_s,
                                    self.median_s * math.exp(self.sigma * norm.inv_cdf(p))))
                for p in probs]
        pauses = [self.pause_min_s + p * (self.pause_max_s - self.pause_min_s) for p in probs]
        return utts, pauses


def stream_rng(seed: int, stream: int, *part: int) -> np.random.Generator:
    """A generator of one stream, from the run's seed: its schedule (no
    ``part``), a block of its noise floor (``part`` 0, i) or its k-th
    utterance's voice (``part`` 1, k). Apart, so that a longer stream only
    appends."""
    return np.random.default_rng([int(seed) & (2**64 - 1), int(stream), *part])


def schedule(rng: np.random.Generator, mix: UtteranceMix,
             seconds: float) -> list[tuple[int, int]]:
    """[(start, end) samples] of the utterances of a stream that lasts
    ``seconds``: a pause first (so a stream opens with silence, as a caller
    does), then utterance, pause, utterance ... The fixed lengths are dealt
    in a shuffled order, reshuffled each time they run out."""
    utts, pauses = mix.lengths()
    out: list[tuple[int, int]] = []
    t = 0.0
    order_u: list[float] = []
    order_p: list[float] = []
    while True:
        if not order_p:
            order_p = [pauses[i] for i in rng.permutation(len(pauses))]
        t += order_p.pop()
        if not order_u:
            order_u = [utts[i] for i in rng.permutation(len(utts))]
        length = order_u.pop()
        if t >= seconds:
            return out
        start = int(round(t * SR))
        end = min(int(round((t + length) * SR)), int(seconds * SR))
        out.append((start, end))
        t += length


def _f0_walk(rng: np.random.Generator, n: int) -> np.ndarray:
    """The surrogate's pitch: a random walk clipped to 85-255 Hz, one value
    per 10 ms, as one per sample (f64)."""
    frames = n // 160 + 1
    steps = rng.normal(0.0, 2.0, size=frames)
    f = rng.uniform(100.0, 220.0)
    vals = np.empty(frames)
    for i in range(frames):
        f = min(255.0, max(85.0, f + steps[i] * 3.0))
        vals[i] = f
    return np.repeat(vals, 160)[:n]


def utterance(rng: np.random.Generator, n: int, device) -> torch.Tensor:
    """One utterance of ``n`` samples, f32 on ``device``, peak = a gain drawn
    in [0.3, 0.9]."""
    f0 = _f0_walk(rng, n)
    phase = 2.0 * np.pi * np.cumsum(f0) / SR
    formants = rng.uniform([400.0, 1200.0, 2300.0], [800.0, 1900.0, 3000.0])
    syl_hz = rng.uniform(2.0, 6.0)
    syl_phase = rng.uniform(0.0, 6.28)
    gain = rng.uniform(0.3, 0.9)
    f0_t = torch.from_numpy(f0).to(device)
    ph = torch.from_numpy(phase).to(device)
    h = torch.arange(1, N_HARMONICS + 1, device=device, dtype=torch.float64)[:, None]
    freq = h * f0_t[None, :]
    amp = sum(torch.exp(-0.5 * ((freq - float(fc)) / FORMANT_BW) ** 2) for fc in formants)
    amp = (amp + 0.05) / torch.sqrt(h)
    sig = (amp * torch.sin(torch.remainder(h * ph[None, :], 2.0 * math.pi))).sum(0)
    t = torch.arange(n, device=device, dtype=torch.float64) / SR
    env = 0.55 + 0.45 * torch.sin(2.0 * math.pi * syl_hz * t + syl_phase)
    ramp = min(RAMP, n)
    env[:ramp] *= torch.linspace(0.0, 1.0, ramp, device=device, dtype=torch.float64)
    env[n - ramp:] *= torch.linspace(1.0, 0.0, ramp, device=device, dtype=torch.float64)
    sig = sig * env
    return (sig / (sig.abs().max() + 1e-9) * gain).to(torch.float32)


#: the room's noise floor under every stream (RMS, full scale 1), drawn in
#: blocks of 10 s
NOISE_RMS = 1e-3
NOISE_BLOCK = 10 * SR


def render(seed: int, stream: int, spans: list[tuple[int, int]], n: int,
           device) -> np.ndarray:
    """A stream's audio of ``n`` samples: its utterances over a low noise
    floor, made on ``device`` and returned as f32 numpy."""
    audio = torch.empty(n, device=device, dtype=torch.float32)
    gen = torch.Generator(device=device)
    for i, a in enumerate(range(0, n, NOISE_BLOCK)):  # a block a draw: a longer stream appends
        gen.manual_seed(int(stream_rng(seed, stream, 0, i).integers(0, 2**62)))
        m = min(NOISE_BLOCK, n - a)
        audio[a: a + m] = torch.randn(m, generator=gen, device=device) * NOISE_RMS
    for k, (start, end) in enumerate(spans):
        if end > start:
            audio[start:end] += utterance(stream_rng(seed, stream, 1, k), end - start, device)
    return audio.clamp_(-1.0, 1.0).cpu().numpy()


@dataclasses.dataclass
class Stream:
    """One stream's audio and its ground truth: utterance spans in samples."""

    audio: np.ndarray
    spans: list[tuple[int, int]]

    def last_speech(self, a: int, b: int) -> int:
        """The end (exclusive) of the last speech sample in [a, b), or -1
        when the packet holds no speech."""
        last = -1
        for start, end in self.spans:
            if start < b and end > a:
                last = max(last, min(end, b))
        return last


def make_stream(seed: int, index: int, mix: UtteranceMix, seconds: float, device) -> Stream:
    spans = schedule(stream_rng(seed, index), mix, seconds)
    return Stream(render(seed, index, spans, int(math.ceil(seconds * SR)), device), spans)
