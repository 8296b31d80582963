"""The port's log-mel frontend against the JAX package's.

On the CPU the port's ``log_mel_spectrogram`` runs its plain torch version;
it is held against the JAX package's Pallas kernel (interpret mode on the
CPU) and the f64 numpy oracle with the energy-aware tolerances of
tests/test_logmel.py. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_whisper_asr_tpu.ops import log_mel_spectrogram as jax_log_mel_spectrogram
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram_reference
from realtime_whisper_asr_tpu.ops import mel as jax_mel
from realtime_whisper_asr_tpu_torch.ops import logmel
from realtime_whisper_asr_tpu_torch.ops import mel

torch.set_num_threads(2)

SR = 16000


def _speechy_audio(seconds: float, seed: int = 0) -> np.ndarray:
    """Synthetic speech-ish signal: AM-modulated harmonics + noise bursts."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t))
    sig = sig * env + 0.05 * rng.standard_normal(t.shape)
    return (0.5 * sig / np.max(np.abs(sig))).astype(np.float32)


def _assert_logmel_close(ours: np.ndarray, golden: np.ndarray):
    """tests/test_logmel.py's tolerances: tight on bins within ~4 decades of
    the peak, bounded near the clamp floor where f32 DFTs disagree."""
    diff = np.abs(ours - golden)
    hot = golden > 0.3
    assert hot.any()
    assert diff[hot].max() < 2e-2, f"hot-bin max diff {diff[hot].max()}"
    assert diff.mean() < 3e-3, f"mean diff {diff.mean()}"
    assert diff.max() < 0.5, f"overall max diff {diff.max()}"


@pytest.mark.parametrize("seconds,n_mels", [(1.0, 80), (1.0, 128), (30.0, 80)])
def test_plain_matches_jax_and_f64_oracle(seconds, n_mels):
    audio = _speechy_audio(seconds)
    ours = logmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert ours.shape == (len(audio) // logmel.HOP_LENGTH, n_mels)
    _assert_logmel_close(ours, log_mel_spectrogram_reference(audio, n_mels=n_mels))
    jax_out = np.asarray(jax_log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    _assert_logmel_close(ours, jax_out)


def test_silence_is_constant_floor():
    out = logmel.log_mel_spectrogram(torch.zeros(SR)).numpy()
    assert np.allclose(out, out.flat[0])


def test_cpu_tensor_takes_plain_version_without_launch():
    audio = torch.from_numpy(_speechy_audio(1.0, seed=3))
    before = logmel.logmel_launches
    out = logmel.log_mel_spectrogram(audio, n_mels=80)
    assert logmel.logmel_launches == before
    torch.testing.assert_close(out, logmel.log_mel_spectrogram_plain(audio, n_mels=80),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(16000, dtype=torch.float64), TypeError),
    (torch.zeros(16001), ValueError),
    (torch.zeros(160), ValueError),
    (torch.zeros(2, 16000), ValueError),
    (torch.zeros(32000)[::2], ValueError),
])
def test_rejects_windows_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        logmel.log_mel_spectrogram(bad)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_tables_equal_jax_package(n_mels):
    np.testing.assert_array_equal(mel.mel_filterbank(n_mels, 400),
                                  jax_mel.mel_filterbank(n_mels, 400))
    np.testing.assert_array_equal(mel.hann_window(400), jax_mel.hann_window(400))
    for ours, ref in zip(mel.dft_matrices(400), jax_mel.dft_matrices(400)):
        np.testing.assert_array_equal(ours, ref)
