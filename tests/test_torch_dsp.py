"""The port's DSP stages against the JAX package's, on the CPU.

- ``ops.dsp.bandpass_filter`` at each of ``BandpassSeparator``'s buckets:
  within 1e-6 (the two FFT libraries differ in the last bits).
- ``ops.dsp.time_stretch`` at rates 0.8, 1.0 and 1.25, without and with the
  carried phase over three consecutive chunks (each chunk fed the JAX
  side's phase, so the chunks' errors do not compound): output within 2e-3
  and carried phase within 0.05 rad. The gap is XLA's CPU ``atan2`` (glibc's
  ``atan2f``) against torch's: they differ by an ulp in ~16 % of angles,
  and the phase accumulates advances of up to ~800 rad a hop, so an ulp of
  one deviation becomes a few ulps of a phase of a few thousand radians.
  ``cumsum_blocked`` itself equals XLA's cumulative sum bit for bit.
- ``ops.features.dedup_features`` at B = 3 with ``n_valid``: within 1e-6,
  and the roll-off bin's near-tie margin logged.
- ``AudioDeduplicator`` (host and device features), the speech-rate
  adaptation (``SpeechRateAdaptiveProcessor``) and
  ``SpeechRateAudioProcessor``: equal decisions over a seeded sequence.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_whisper_asr_tpu.pipeline as JP
import realtime_whisper_asr_tpu_torch.pipeline as PP
from realtime_whisper_asr_tpu.ops import dsp as JD
from realtime_whisper_asr_tpu.ops import features as JF
from realtime_whisper_asr_tpu_torch.ops import dsp as PD
from realtime_whisper_asr_tpu_torch.ops import features as PF

torch.set_num_threads(2)
SR = 16000
log = logging.getLogger(__name__)


def _noise(n, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _speechy(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.61 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    env = 0.55 * (1 + np.sin(2 * np.pi * 2.7 * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


@pytest.mark.parametrize("n", [1024, 4096, 16384, 65536, 262144, 1048576])
def test_bandpass_filter_matches_jax(n):
    x = _noise(n, seed=n)
    ref = np.asarray(JD.bandpass_filter(jnp.asarray(x)))
    got = PD.bandpass_filter(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [5, 16, 17, 80, 257, 600, 4097])
def test_cumsum_blocked_equals_xla(n):
    import jax

    x = _noise(n * 3, seed=n, scale=300.0).reshape(n, 3)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(x))
    np.testing.assert_array_equal(PD.cumsum_blocked(torch.from_numpy(x)).numpy(), ref)
    ref_last = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x.T))
    np.testing.assert_array_equal(PD.cumsum_blocked(torch.from_numpy(x.T), dim=-1).numpy(),
                                  ref_last)


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.25])
def test_time_stretch_matches_jax(rate):
    x = _speechy(1.0, seed=3)
    ref = np.asarray(JD.time_stretch(jnp.asarray(x), rate))
    got = PD.time_stretch(torch.from_numpy(x), rate).numpy()
    assert got.shape == ref.shape == (int(len(x) / rate),)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.25])
def test_time_stretch_carried_phase_matches_jax(rate):
    x = _speechy(3.0, seed=4)
    phase = np.zeros(513, np.float32)
    for c in range(3):
        seg = x[c * SR : (c + 1) * SR]
        ref, ref_phase = JD.time_stretch(jnp.asarray(seg), rate, phase_in=jnp.asarray(phase),
                                         carry_phase=True)
        got, got_phase = PD.time_stretch(torch.from_numpy(seg), rate,
                                         phase_in=torch.from_numpy(phase), carry_phase=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-3)
        np.testing.assert_allclose(got_phase.numpy(), np.asarray(ref_phase), rtol=0, atol=0.05)
        phase = np.array(ref_phase)
    # a padded caller's join point (pipeline/stretch.py passes phase_at)
    padded = np.zeros(32000, np.float32)
    padded[:SR] = x[:SR]
    at = (512 + int(SR / rate)) // 256
    _, ref_phase = JD.time_stretch(jnp.asarray(padded), rate, phase_in=jnp.zeros(513),
                                   carry_phase=True, phase_at=jnp.int32(at))
    _, got_phase = PD.time_stretch(torch.from_numpy(padded), rate, phase_in=torch.zeros(513),
                                   carry_phase=True, phase_at=at)
    np.testing.assert_allclose(got_phase.numpy(), np.asarray(ref_phase), rtol=0, atol=0.05)


def test_dedup_features_matches_jax():
    chunks = np.stack([_speechy(16384 / SR, seed=s) for s in range(3)])
    chunks[:, 12000:] = 0.0
    chunks[2] += _noise(16384, seed=9, scale=0.05)
    ref = np.asarray(JF.dedup_features(jnp.asarray(chunks), n_valid=jnp.int32(12000)))
    got = PF.dedup_features(torch.from_numpy(chunks), n_valid=12000).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the roll-off is an argmax over cum >= 0.85 total: log how far the
    # chosen bin's cumulative energy sits from the threshold
    spec = np.abs(np.fft.rfft(chunks.astype(np.float64), axis=-1)) ** 2
    cum = np.cumsum(spec, axis=-1)
    target = 0.85 * cum[:, -1:]
    idx = np.argmax(cum >= target, axis=-1)
    margin = np.min(np.abs(cum[np.arange(3), idx] - target[:, 0]) / cum[:, -1])
    log.info("dedup_features roll-off: smallest relative margin to the threshold %.3e", margin)
    full = np.asarray(JF.dedup_features(jnp.asarray(chunks)))
    np.testing.assert_allclose(PF.dedup_features(torch.from_numpy(chunks)).numpy(), full,
                               rtol=0, atol=1e-6)


def _dedup_sequence():
    """Seeded chunks with exact repeats, near repeats and fresh audio."""
    rng = np.random.default_rng(11)
    base = [_speechy(0.5, seed=s) for s in range(4)]
    seq = []
    for i in range(24):
        k = int(rng.integers(0, 4))
        chunk = base[k].copy()
        if rng.random() < 0.3:
            chunk += _noise(len(chunk), seed=i, scale=0.01)
        if rng.random() < 0.2:
            chunk = _noise(len(chunk), seed=100 + i, scale=0.2)
        seq.append((0.5 * i, chunk))
    return seq


@pytest.mark.parametrize("use_device", [False, True], ids=["host", "device"])
def test_audio_deduplicator_decisions_match_jax(use_device):
    kw = dict(similarity_threshold=0.98, duplicate_threshold=0.995, time_window_s=5.0)
    ref = JP.AudioDeduplicator(use_device=use_device, **kw)
    got = PP.AudioDeduplicator(use_device=use_device, device="cpu", **kw)
    decisions = []
    for now, chunk in _dedup_sequence():
        a, b = ref.should_skip(chunk, now), got.should_skip(chunk, now)
        assert a[0] == b[0]
        decisions.append(a[0])
    assert any(decisions) and not all(decisions)
    assert {k: v for k, v in ref.get_stats().items()} == got.get_stats()


def test_speech_rate_adaptive_processor_matches_jax():
    class Vac:
        def __init__(self):
            self.ms = []

        def set_silence_duration(self, ms):
            self.ms.append(ms)

    clock = {"t": 0.0}
    procs = []
    for P in (JP, PP):
        vac = Vac()
        procs.append((vac, P.SpeechRateAdaptiveProcessor(vac, update_interval_s=2.0,
                                                          clock=lambda: clock["t"])))
    rng = np.random.default_rng(5)
    for i in range(40):
        clock["t"] = 0.7 * i
        text = "x" * int(rng.integers(2, 30))
        beg = 0.7 * i
        end = beg + float(rng.uniform(0.3, 2.0))
        for _, proc in procs:
            proc.on_result(text, beg, end, clock["t"])
    (va, pa), (vb, pb) = procs
    assert va.ms == vb.ms and va.ms
    assert pa.detector.classify() == pb.detector.classify()


def test_speech_rate_audio_processor_matches_jax():
    """Rates 0.8, 1.0 and 1.2 over a chunk sequence (held chunks, flushes,
    carried phases): the same lengths, applied rates and stats, audio within
    the time-stretch tolerance."""
    ref = JP.SpeechRateAudioProcessor()
    got = PP.SpeechRateAudioProcessor(device="cpu")
    x = _speechy(8.0, seed=6)
    cps = [20.0, 20.0, None, 6.0, 6.0, 8.5, 10.0, 14.0, 14.0, 20.0, 3.0, 3.0]
    pos = 0
    for i, c in enumerate(cps):
        n = 3000 if i in (0, 4) else 8000
        chunk = x[pos : pos + n]
        pos += n
        a, b = ref.process(chunk, c), got.process(chunk, c)
        assert len(a) == len(b) and ref.applied_rate == got.applied_rate
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-3)
        assert (ref._phase is None) == (got._phase is None)
    assert ref.stats == got.stats and ref.stats["stretched"] >= 4


def test_adaptive_whisper_params_match_jax():
    for base in (1, 3):
        for cls in ("slow", "normal", "fast", "unknown"):
            assert (PP.AdaptiveWhisperParams(base_beam_size=base).get_transcribe_kwargs(cls)
                    == JP.AdaptiveWhisperParams(base_beam_size=base).get_transcribe_kwargs(cls))
