"""Synthetic speech/non-speech corpus for VAD training and evaluation.

No network access means no real VAD training data; this generator produces
labeled mixtures whose *spectral* structure separates speech from non-speech
the way real corpora do — including the cases an energy VAD cannot get right
(loud steady tones, music beds, hum) so a trained spectral model has something
real to beat.

Speech-like signals: harmonic series under a pitch random-walk with formant
shaping and a 2–6 Hz syllabic envelope, separated by silences. Non-speech:
white/pink noise, mains hum, steady tones, and chordal "music" with a beat.
Labels are per 512-sample frame (the Silero frame convention).
"""

from __future__ import annotations

import numpy as np

SR = 16000
FRAME = 512


def _syllable_envelope(rng: np.random.Generator, n: int) -> np.ndarray:
    """Bursty 2-6 Hz amplitude envelope with inter-utterance silences."""
    env = np.zeros(n, np.float32)
    t = 0
    while t < n:
        if rng.random() < 0.65:  # an utterance: 0.4-2.0 s of syllables
            dur = int(rng.uniform(0.4, 2.0) * SR)
            syl_hz = rng.uniform(2.0, 6.0)
            tt = np.arange(min(dur, n - t)) / SR
            burst = 0.55 + 0.45 * np.sin(2 * np.pi * syl_hz * tt + rng.uniform(0, 6.28))
            ramp = min(400, burst.size)
            burst[:ramp] *= np.linspace(0, 1, ramp)
            burst[-ramp:] *= np.linspace(1, 0, ramp)
            env[t : t + burst.size] = burst
            t += dur
        else:  # a pause: 0.3-1.5 s
            t += int(rng.uniform(0.3, 1.5) * SR)
    return env


def synth_speech(rng: np.random.Generator, seconds: float) -> tuple[np.ndarray, np.ndarray]:
    """(audio, per-sample activity) — harmonic + formant speech surrogate."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    # pitch random walk 85-255 Hz
    f0 = np.empty(n, np.float32)
    f = rng.uniform(100, 220)
    step = rng.normal(0, 2.0, size=n // 160 + 1)
    for i in range(0, n, 160):
        f = float(np.clip(f + step[i // 160] * 3, 85, 255))
        f0[i : i + 160] = f
    phase = 2 * np.pi * np.cumsum(f0) / SR
    formants = rng.uniform([400, 1200, 2300], [800, 1900, 3000])
    sig = np.zeros(n, np.float32)
    for h in range(1, 30):
        freq = h * f0
        # formant envelope: sum of gaussians over frequency
        amp = sum(np.exp(-0.5 * ((freq - fc) / 280.0) ** 2) for fc in formants)
        amp = (amp + 0.05) / h**0.5
        sig += (amp * np.sin(h * phase)).astype(np.float32)
    env = _syllable_envelope(rng, n)
    sig *= env
    peak = np.abs(sig).max() + 1e-9
    return (sig / peak).astype(np.float32), (env > 0.15).astype(np.float32)


def synth_nonspeech(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    kind = rng.integers(0, 5)
    if kind == 0:  # white noise
        sig = rng.standard_normal(n)
    elif kind == 1:  # pink-ish noise (1/sqrt(f) spectral shaping)
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.fft.rfftfreq(n, 1 / SR)
        sig = np.fft.irfft(spec / np.sqrt(np.maximum(f, 20.0)), n)
    elif kind == 2:  # mains hum + harmonics
        sig = sum(np.sin(2 * np.pi * 50 * h * t + rng.uniform(0, 6)) / h for h in range(1, 6))
    elif kind == 3:  # loud steady tone — the energy-VAD killer
        sig = np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
    else:  # chordal music bed with a beat
        root = rng.uniform(110, 440)
        sig = sum(np.sin(2 * np.pi * root * r * t + rng.uniform(0, 6)) for r in (1, 1.25, 1.5, 2))
        sig *= 0.7 + 0.3 * np.sin(2 * np.pi * 2.0 * t)  # 120 bpm beat
    sig = np.asarray(sig, np.float32)
    peak = np.abs(sig).max() + 1e-9
    return sig / peak


def synth_example(
    rng: np.random.Generator, seconds: float = 4.0
) -> tuple[np.ndarray, np.ndarray]:
    """One labeled training example: (audio (n,), frame labels (n//FRAME,)).

    Mix classes: pure non-speech / clean speech / speech over non-speech at
    SNR −5..20 dB. Level-randomized so absolute energy is not a label cue.
    """
    n = int(seconds * SR)
    u = rng.random()
    if u < 0.3:
        audio = synth_nonspeech(rng, seconds) * rng.uniform(0.05, 1.0)
        activity = np.zeros(n, np.float32)
    else:
        speech, activity = synth_speech(rng, seconds)
        audio = speech
        if u < 0.85:  # mixture
            noise = synth_nonspeech(rng, seconds)
            snr_db = rng.uniform(-5.0, 20.0)
            sp = np.sqrt(np.mean(speech**2) + 1e-9)
            np_ = np.sqrt(np.mean(noise**2) + 1e-9)
            audio = speech + noise * (sp / np_) * 10 ** (-snr_db / 20)
        audio = audio * rng.uniform(0.05, 1.0)
    audio = audio[:n].astype(np.float32)
    frames = n // FRAME
    labels = activity[: frames * FRAME].reshape(frames, FRAME).mean(-1)
    return audio, (labels > 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# speaker-conditioned synthesis (diarization training, models/speaker.py)
# ---------------------------------------------------------------------------


def sample_speaker(rng: np.random.Generator) -> dict:
    """A synthetic speaker identity: fixed vocal anatomy (formant positions /
    bandwidths, pitch register, spectral tilt); utterances then vary phrase,
    pitch contour, and noise while these stay put — the invariances a speaker
    embedding must learn."""
    return {
        "f0_base": float(rng.uniform(90, 250)),
        "f0_range": float(rng.uniform(10, 40)),
        "formants": rng.uniform([350, 1100, 2200], [900, 2000, 3100]).astype(np.float64),
        "formant_bw": float(rng.uniform(180, 380)),
        "tilt": float(rng.uniform(0.3, 0.9)),  # harmonic rolloff exponent
        "breath": float(rng.uniform(0.0, 0.08)),  # aspiration noise level
    }


def synth_speaker_utterance(
    rng: np.random.Generator, spk: dict, seconds: float = 2.0, snr_db: float | None = None
) -> np.ndarray:
    """One utterance by ``spk``: speaker-fixed anatomy, utterance-random
    phrase/contour (and optional additive noise at ``snr_db``)."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = np.empty(n, np.float32)
    f = spk["f0_base"] + rng.uniform(-0.3, 0.3) * spk["f0_range"]
    lo, hi = spk["f0_base"] - spk["f0_range"], spk["f0_base"] + spk["f0_range"]
    step = rng.normal(0, 2.0, size=n // 160 + 1)
    for i in range(0, n, 160):
        f = float(np.clip(f + step[i // 160] * 2.5, lo, hi))
        f0[i : i + 160] = f
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = np.zeros(n, np.float32)
    for h in range(1, 30):
        freq = h * f0
        amp = sum(
            np.exp(-0.5 * ((freq - fc) / spk["formant_bw"]) ** 2) for fc in spk["formants"]
        )
        amp = (amp + 0.05) / h ** spk["tilt"]
        sig += (amp * np.sin(h * phase)).astype(np.float32)
    if spk["breath"] > 0:
        sig += spk["breath"] * rng.standard_normal(n).astype(np.float32)
    env = _syllable_envelope(rng, n)
    # ensure the utterance actually contains voiced content
    if env.max() <= 0:
        env[:] = 0.7
    sig *= env
    if snr_db is not None:
        noise = synth_nonspeech(rng, seconds)[:n]
        sp = np.sqrt(np.mean(sig**2) + 1e-9)
        np_ = np.sqrt(np.mean(noise**2) + 1e-9)
        sig = sig + noise * (sp / np_) * 10 ** (-snr_db / 20)
    peak = np.abs(sig).max() + 1e-9
    return (sig / peak * rng.uniform(0.3, 1.0)).astype(np.float32)
