"""The port's vocal separation against the JAX package's, on the CPU.

- ``separate_vocals`` and ``separate_stems_device`` against the JAX
  package's jitted functions for the three packaged variants (default,
  small, 4stem) and a JAX-initialized v2 net carried across by
  ``params_from_jax``, at 16,384 and 65,536 samples: within 1e-5 (measured
  ~2e-7: two FFT libraries and two conv orders). A batch of rows equals
  each row separated alone within the same tolerance.
- The host mirror (numpy STFT, torch's CPU convolutions) equals the JAX
  package's bit for bit, and ``separate_stems_np`` too.
- ``overlap_windowed`` past the last bucket, ``NeuralSeparator`` and
  ``BandpassSeparator`` (device and host paths, the length rules) against
  the JAX separators; ``create_separator`` for each method.
- The copied npz files have the JAX package's sha256.
- The fused frontend: the default separator set on both ASRs (golden
  test-tiny weights at f32): ``_encode_many`` within 1e-4 of the JAX
  package's (the separation's ~1e-7 through log-mel and the encoder), and
  golden clip 0's tokens through ``transcribe`` equal to
  ``TPUWhisperASR``'s. A token mismatch would be reported with its top-2
  margin (none occurs).
"""

import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realtime_whisper_asr_tpu.pipeline.separation as JPS
import realtime_whisper_asr_tpu_torch.pipeline.separation as PPS
from realtime_whisper_asr_tpu.models import separation_nn as JS
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models import separation_nn as PS
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000
TOL = 1e-5


def _mix(n, seed=0):
    """Speech-like harmonics over a music-like bed and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.61 * t)
    speech = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    speech *= 0.55 * (1 + np.sin(2 * np.pi * 2.7 * t))
    music = 0.15 * (np.sin(2 * np.pi * 220 * t) + 0.7 * np.sin(2 * np.pi * 330 * t))
    out = 0.3 * speech / np.max(np.abs(speech)) + music + 0.02 * rng.standard_normal(n)
    return out.astype(np.float32)


def _nets():
    nets = {v: dict(np.load(JS.VARIANT_WEIGHTS[v])) for v in ("default", "small", "4stem")}
    init = JS.init_separator_params_v2(jax.random.PRNGKey(3), channels=JS.V2_SMALL_CHANNELS)
    nets["jax-init"] = {k: np.asarray(v) for k, v in init.items()}
    return nets


NETS = _nets()


@pytest.mark.parametrize("n", [16384, 65536])
@pytest.mark.parametrize("net", list(NETS))
def test_separate_vocals_and_stems_match_jax(net, n):
    params = NETS[net]
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = PS.params_from_jax(params, "cpu")
    assert PS.arch_of(tparams) == JS.arch_of(params) == PS.arch_of(params)
    assert PS.n_stems_of(tparams) == JS.n_stems_of(params)
    x = _mix(n, seed=n)
    dil = JS.arch_of(params)[0]
    ref = np.asarray(JS.separate_vocals(jparams, jnp.asarray(x), dil=dil))
    got = PS.separate_vocals(tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    ref_stems = np.asarray(JS.separate_stems_device(jparams, jnp.asarray(x), dil=dil))
    got_stems = PS.separate_stems_device(tparams, torch.from_numpy(x)).numpy()
    assert got_stems.shape == ref_stems.shape == (JS.n_stems_of(params), n)
    np.testing.assert_allclose(got_stems, ref_stems, rtol=0, atol=TOL)


def test_batched_rows_equal_rows_alone():
    tparams = PS.params_from_jax(NETS["default"], "cpu")
    rows = torch.from_numpy(np.stack([_mix(16384, seed=s) for s in range(3)]))
    batched = PS.separate_vocals(tparams, rows)
    for i in range(3):
        np.testing.assert_allclose(batched[i].numpy(),
                                   PS.separate_vocals(tparams, rows[i]).numpy(),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("net", ["default", "4stem"])
def test_host_mirror_equals_jax_host_mirror(net):
    x = _mix(20000, seed=5)
    params = NETS[net]
    np.testing.assert_array_equal(PS.separate_vocals_np(params, x),
                                  JS.separate_vocals_np(params, x))
    np.testing.assert_array_equal(PS.separate_stems_np(params, x),
                                  JS.separate_stems_np(params, x))


def test_packaged_weights_are_the_jax_packages():
    port_dir = os.path.dirname(PS.VARIANT_WEIGHTS["default"])
    jax_dir = os.path.dirname(JS.VARIANT_WEIGHTS["default"])
    names = sorted(f for f in os.listdir(jax_dir) if f.endswith(".npz"))
    assert names == ["separation_nn.npz", "separation_nn_4stem.npz",
                     "separation_nn_small.npz", "speaker_nn.npz"]
    for name in names:
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert hashlib.sha256(a.read()).digest() == hashlib.sha256(b.read()).digest(), name


def test_overlap_windowed_equals_jax():
    x = _mix(50000, seed=8)
    fn = lambda seg: np.tanh(3.0 * seg) * np.linspace(0.5, 1.0, len(seg))  # noqa: E731
    np.testing.assert_array_equal(PPS.overlap_windowed(fn, x, 16384),
                                  JPS.overlap_windowed(fn, x, 16384))


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_neural_separator_matches_jax_past_the_last_bucket(use_device):
    """Long input through the windowed joins (the buckets cut to 16,384
    on both sides so the windows are short), and the short-input rule."""
    ref = JS.NeuralSeparator(use_device=use_device)
    got = PPS.create_separator("neural", use_device=use_device, device="cpu")
    assert got.trained and got.variant == "default"
    ref._buckets = [16384]
    got._buckets = [16384]
    x = _mix(40000, seed=9)
    np.testing.assert_allclose(got.separate(x), ref.separate(x), rtol=0, atol=TOL)
    short = _mix(1000)
    assert got.separate(short) is short and ref.separate(short) is short
    stems_ref, stems_got = ref.separate_stems(x[:16000]), got.separate_stems(x[:16000])
    assert sorted(stems_got) == sorted(stems_ref) == ["accompaniment", "vocals"]
    for k in stems_ref:
        np.testing.assert_allclose(stems_got[k], stems_ref[k], rtol=0, atol=TOL)
    assert got.get_stats() == ref.get_stats()


def test_four_stem_separator_matches_jax():
    ref = JS.NeuralSeparator(variant="4stem")
    got = PS.NeuralSeparator(variant="4stem", device="cpu")
    x = _mix(16000, seed=10)
    a, b = ref.separate_stems(x), got.separate_stems(x)
    assert sorted(a) == sorted(b) == ["accompaniment", "bass", "drums", "other", "vocals"]
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [63, 1000, 4096, 20000, 70000])
@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_bandpass_separator_matches_jax(use_device, n):
    ref = JPS.BandpassSeparator(use_device=use_device)
    got = PPS.BandpassSeparator(use_device=use_device, device="cpu")
    x = _mix(n, seed=n)
    a, b = ref.separate(x), got.separate(x)
    assert len(a) == len(b) == n
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_create_separator_each_method():
    common = {"low_hz": 85.0, "high_hz": 3400.0, "device": "cpu"}
    assert PPS.create_separator("filter", **common).name == "filter"
    neural = PPS.create_separator("neural", variant="small", **common)
    assert neural.name == "neural" and neural.variant == "small"
    # demucs is not installed: the band-pass separator, as in the JAX package
    assert PPS.create_separator("demucs", model_name="htdemucs", **common).name == "filter"
    assert PPS.create_separator("spleeter", **common).name == "filter"
    for off in ("none", "", None, False):
        assert PPS.create_separator(off, **common) is None
    with pytest.raises(ValueError, match="unknown separation method"):
        PPS.create_separator("bogus")
    with pytest.raises(ValueError, match="unknown separator variant"):
        PS.NeuralSeparator(variant="bogus", device="cpu")


def test_save_and_load_npz_round_trip(tmp_path):
    sep = PS.NeuralSeparator(variant="small", use_device=False)
    path = str(tmp_path / "sep.npz")
    sep.save_npz(path)
    back = PS.NeuralSeparator.load_npz(path, use_device=False)
    x = _mix(8000)
    np.testing.assert_array_equal(back.separate(x), sep.separate(x))


# ------------------------------------------------------------ fused frontend


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """tools/golden.py's deterministic synthetic clips."""
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


@pytest.fixture(scope="module")
def fused_asrs():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden as G

    ours = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                           params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    ours.transcribe_kargs["max_total_tokens"] = 24  # as build_asr
    ref = G.build_asr()
    sep = dict(np.load(JS.VARIANT_WEIGHTS["default"]))
    ours.set_separation_frontend(sep)
    ref.set_separation_frontend(sep)
    return ours, ref


def _first_mismatch_margin(asr, audio, tokens_ref, tokens_got) -> str:
    """Where the two transcripts part, and the port's top-2 logit margin
    there, the JAX package's tokens teacher-forced up to that point."""
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    k = next((i for i, (a, b) in enumerate(zip(tokens_ref, tokens_got)) if a != b),
             min(len(tokens_ref), len(tokens_got)))
    plan = D.plan_window(asr.cfg, asr._make_opts())
    asr._sync_audio_and_aux(audio, plan.aux)
    with torch.inference_mode():
        xa = asr._encode_from_buf(len(audio))
        seq = torch.from_numpy(np.concatenate([plan.init, tokens_ref[:k]]).astype(np.int64))
        logits, _ = asr.model.decode_span(seq[None], 0, asr.model.init_cache(xa, text_ctx=128))
    top = torch.topk(logits[0, -1].float(), 2).values
    return (f"tokens part at {k}: JAX {tokens_ref[k:k + 1]} vs port {tokens_got[k:k + 1]}, "
            f"the port's top-2 margin there {float(top[0] - top[1]):.3e}")


def test_fused_frontend_encode_and_golden_tokens_equal_jax(fused_asrs):
    ours, ref = fused_asrs
    audio = golden_audio(0)
    got, want = ours.transcribe(audio), ref.transcribe(audio)
    assert list(got.tokens) == list(want.tokens), _first_mismatch_margin(
        ours, audio, list(want.tokens), list(got.tokens))
    assert [s.text for s in got] == [s.text for s in want]
    key = ours._active_stream
    enc = ours._encode_many([key], [len(audio)]).numpy()
    enc_ref = np.asarray(ref._encode_many([ref._active_stream], [len(audio)]))
    np.testing.assert_allclose(enc, enc_ref, rtol=0, atol=1e-4)
    # the frontend really runs: without it the encoder sees another signal
    frontend = ours._sep_frontend
    ours.set_separation_frontend(None)
    try:
        plain = ours._encode_many([key], [len(audio)]).numpy()
    finally:
        ours._sep_frontend = frontend
    assert np.abs(plain - enc).max() > 1e-2
    # detect_language encodes its window unseparated, in both packages
    lang, prob = ours.detect_language(audio)
    ours.set_separation_frontend(None)
    try:
        assert ours.detect_language(audio) == (lang, prob)
    finally:
        ours._sep_frontend = frontend
    ref_lang, ref_prob = ref.detect_language(audio)
    assert lang == ref_lang and abs(prob - ref_prob) < 1e-4
