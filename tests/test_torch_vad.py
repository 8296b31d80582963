"""The port's VADs against the JAX package's, on the CPU.

- ``EnergyVAD`` equals the JAX package's bit for bit (numpy on both sides).
- ``SileroLikeNet.forward`` matches the JAX ``vad_scan`` on the packaged
  weights and on seeded random parameters (the JAX initializer's, carried
  across with ``params_from_jax``), with the state carried across calls;
  the streaming adapter matches the JAX numpy ``SileroLikeVAD.__call__``.
  Tolerance: 2e-5 on the probabilities (f32 sums in other orders, an FFT
  of another library).
- The JAX package's ``params_from_torch_state_dict`` reads the port's state
  dict back into the packaged arrays, and the port's copy of the npz is the
  JAX package's, array for array.
- ``VADIterator`` gives the JAX package's events on the golden VAC audio
  (``tools/golden.py:113-123``) with either VAD; the smallest distance of a
  probability to the thresholds 0.5 and 0.35 is printed, so that a flip can
  be told from a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models.vad import energy as JE
from realtime_whisper_asr_tpu.models.vad import silero_like as JS
from realtime_whisper_asr_tpu.models.vad import synthetic as JSyn
from realtime_whisper_asr_tpu.streaming import vac as JV
from realtime_whisper_asr_tpu_torch.models.vad import energy as PE
from realtime_whisper_asr_tpu_torch.models.vad import silero_like as PS
from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech
from realtime_whisper_asr_tpu_torch.streaming import vac as PV

torch.set_num_threads(2)

SR = 16000
TOL = 2e-5


def golden_vac_audio() -> np.ndarray:
    """tools/golden.py's VAC clip: two synthetic utterances with gaps."""
    rng = np.random.default_rng(2024)
    a, _ = synth_speech(rng, 3.0)
    b, _ = synth_speech(rng, 3.0)
    gap = np.zeros(int(1.2 * SR), np.float32)
    lead = np.zeros(int(0.4 * SR), np.float32)
    return np.concatenate([lead, a, gap, b, gap]).astype(np.float32)


def _frames(seed: int, n: int, level: float = 0.2) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, PS.FRAME)) * level).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_speech_equals_jax(seed):
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for got, ref in zip(synth_speech(rng_a, 2.0), JSyn.synth_speech(rng_b, 2.0)):
        assert np.array_equal(got, ref)


def test_golden_vac_audio_equals_the_recorders():
    rng = np.random.default_rng(2024)
    a, _ = JSyn.synth_speech(rng, 3.0)
    b, _ = JSyn.synth_speech(rng, 3.0)
    gap, lead = np.zeros(int(1.2 * SR), np.float32), np.zeros(int(0.4 * SR), np.float32)
    assert np.array_equal(golden_vac_audio(), np.concatenate([lead, a, gap, b, gap]))


# ---------------------------------------------------------------- energy VAD


def _energy_inputs():
    """tests/test_streaming.py's silence and tone, seeded noise at three
    levels, and the golden VAC clip cut into frames."""
    rng = np.random.default_rng(0)
    t = np.arange(40 * 512) / SR
    tone = (0.3 * np.sin(2 * np.pi * 700 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    va = golden_vac_audio()
    return {
        "silence": (1e-4 * rng.standard_normal((40, 512))).astype(np.float32),
        "tone": tone.astype(np.float32).reshape(40, 512),
        **{f"noise{lvl}": _frames(7, 30, lvl) for lvl in (1e-3, 0.05, 0.5)},
        "golden_vac": va[: len(va) // 512 * 512].reshape(-1, 512),
    }


@pytest.mark.parametrize("name", ["silence", "tone", "noise0.001", "noise0.05", "noise0.5",
                                  "golden_vac"])
def test_energy_vad_equals_jax(name):
    """Frame by frame and in one batch, the state carried across calls."""
    frames = _energy_inputs()[name]
    ours, ref = PE.EnergyVAD(), JE.EnergyVAD()
    for chunk in (frames[:1], frames[1:9], frames[9:]):
        assert np.array_equal(ours(chunk), ref(chunk))
    assert ours.noise_floor_db == ref.noise_floor_db


# ----------------------------------------------------------- Silero-like VAD


def _params(kind: str) -> dict:
    if kind == "packaged":
        return PS.load_packaged_params()
    return {k: np.asarray(v) for k, v in JS.init_vad_params(jax.random.PRNGKey(5)).items()}


@pytest.mark.parametrize("n", [1, 7, 40])
@pytest.mark.parametrize("kind", ["packaged", "random"])
def test_forward_matches_vad_scan(kind, n):
    """Three calls of N frames each, the state carried across them."""
    params = _params(kind)
    net = PS.SileroLikeNet("cpu")
    net.load_state_dict(PS.params_from_jax(params))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = net.init_state(), JS.init_state()
    for call in range(3):
        frames = _frames(100 * n + call, n)
        with torch.inference_mode():
            probs, state = net(torch.from_numpy(frames), state)
        ref, jstate = JS.vad_scan(jparams, jnp.asarray(frames), jstate)
        assert probs.shape == (n,)
        np.testing.assert_allclose(probs.numpy(), np.asarray(ref), rtol=0, atol=TOL)
        for got, want in zip(state, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["packaged", "random"])
def test_adapter_matches_the_numpy_microkernel(kind):
    """The streaming adapter against the JAX package's numpy
    ``SileroLikeVAD.__call__`` over calls of 1, 5 and 16 frames, then a
    reset."""
    params = _params(kind)
    ours = PS.SileroLikeVAD(None if kind == "packaged" else params, device="cpu")
    ref = JS.SileroLikeVAD(None if kind == "packaged" else params)
    assert ours.trained == ref.trained == (kind == "packaged")
    for i, n in enumerate((1, 5, 16, 1)):
        if i == 3:
            ours.reset()
            ref.reset()
        frames = _frames(40 + i, n, 0.3)
        np.testing.assert_allclose(ours(frames), ref(frames), rtol=0, atol=TOL)


def test_state_dict_converts_back_to_the_packaged_arrays():
    net = PS.SileroLikeNet("cpu")
    net.load_state_dict(PS.params_from_jax(PS.load_packaged_params()))
    back = JS.params_from_torch_state_dict(net.state_dict())
    packaged = PS.load_packaged_params()
    assert sorted(back) == sorted(packaged)
    for k in packaged:
        assert np.array_equal(back[k], packaged[k]), k
    assert not net.state_dict()["lstm.bias_hh_l0"].any()


def test_packaged_weights_equal_the_jax_packages():
    with np.load(JS._PACKAGED_WEIGHTS) as ref, np.load(PS._PACKAGED_WEIGHTS) as ours:
        assert sorted(ours.files) == sorted(ref.files)
        for k in ref.files:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def test_random_init_is_seeded_and_scaled_as_the_jax_initializer():
    """Same seed, same weights; zero biases; each weight's spread near the
    JAX initializer's sqrt(2 / fan)."""
    a, b, c = (PS.SileroLikeNet("cpu", seed=s) for s in (3, 3, 4))
    jax_std = {k: float(np.std(v)) for k, v in _params("random").items()}
    names = {"proj.weight": "proj_w", "conv.weight": "conv_w", "lstm.weight_ih_l0": "lstm_wx",
             "lstm.weight_hh_l0": "lstm_wh", "head.weight": "head_w"}
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        if "bias" in k:
            assert not v.any()
        else:
            assert not torch.equal(v, c.state_dict()[k])
            assert float(v.std()) == pytest.approx(jax_std[names[k]], rel=0.3)


# ------------------------------------------------------------ VAD iterator


def _events(iterator_cls, prob_fn, audio: np.ndarray) -> tuple[list, list]:
    """(events, probabilities) of ``iterator_cls(prob_fn)`` over ``audio``
    in 0.5 s chunks, as the golden VAC row feeds it."""
    probs = []

    def recording(frames):
        p = prob_fn(frames)
        probs.extend(float(x) for x in p)
        return p

    it = iterator_cls(recording, threshold=0.5, min_silence_duration_ms=500,
                      speech_pad_ms=100)
    events = []
    for pos in range(0, len(audio), SR // 2):
        events.extend(it(audio[pos : pos + SR // 2]))
    return events, probs


@pytest.mark.parametrize("vad", ["silero_like", "energy"])
def test_vad_iterator_events_equal_jax_on_the_golden_vac_audio(vad):
    audio = golden_vac_audio()
    if vad == "silero_like":
        ours_fn, ref_fn = PS.SileroLikeVAD(device="cpu"), JS.SileroLikeVAD()
    else:
        ours_fn, ref_fn = PE.EnergyVAD(), JE.EnergyVAD()
    ours, p_ours = _events(PV.VADIterator, ours_fn, audio)
    ref, p_ref = _events(JV.VADIterator, ref_fn, audio)
    p = np.asarray(p_ours)
    margin = float(np.min(np.minimum(np.abs(p - 0.5), np.abs(p - 0.35))))
    err = float(np.abs(p - np.asarray(p_ref)).max())
    print(f"{vad}: {len(ours)} events, smallest margin to 0.5 / 0.35 {margin:.3g}, "
          f"max |p - p_jax| {err:.3g}")
    assert ours == ref
    assert [next(iter(e)) for e in ours] == ["start", "end", "start", "end"]
    assert err < (TOL if vad == "silero_like" else 1e-12) < margin
