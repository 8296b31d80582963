"""Seeded sampling, the quality-retry ladder and ``detect_language``: the
port against the JAX package, on the CPU at f32.

- ``ops/threefry.py`` against ``jax.random``: the keys of ``fold_in(
  PRNGKey(seed), pos)``, the 32-bit draws of shape (51865,) and the Gumbel
  values, bit-equal over several seeds and positions; ``xla_log`` bit-equal
  to XLA's ``log`` over every input of the sampler's range (all 2^23
  uniforms and their ``-log``), where ``torch.log`` is not.
- The sampled greedy decode (``temperature`` 0.2, 0.6 and 1.0, seeds 1, 3
  and 5; with a draft whose verify samples too) on the golden test-tiny
  weights: the token section of the packed result equal to the JAX
  package's ``greedy_decode`` with the same ``pack_aux(seed=,
  temperature=)``, and a batch of rows with their own seeds equal to the
  JAX package's batched decode.
- ``TorchWhisperASR.transcribe_with_fallback`` against
  ``TPUWhisperASR``'s (``tools/golden.py``'s ``build_asr``), greedy and beam
  3, with ``logprob_threshold`` forced high so every rung runs: tokens
  equal and ``_sample_seed`` advanced by 5 on both, as
  ``tests/test_decode.py::test_beam_with_temperature_ladder``; the five
  rungs share one loop shape.
- ``condition_on_previous_text=False`` on the 40 s input: tokens equal to
  the JAX package's.
- ``detect_language``: the same language, the probability within 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import decode as JD
from realtime_whisper_asr_tpu.models.whisper import quant as JQ
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram as jax_log_mel
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper
from realtime_whisper_asr_tpu_torch.ops import threefry
from tests.test_torch_decode_loop import GOLDEN, _golden_tree, golden_audio

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 51865  # test-tiny's vocabulary, as large-v3's (multilingual)


@pytest.mark.parametrize("seed,pos", [(0, 0), (1, 5), (6, 123), (-3, 447), (2**31 - 1, 2)])
def test_threefry_and_gumbel_equal_jax_random(seed, pos):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
    ours = threefry.fold_in(threefry.prng_key(torch.tensor([seed])), torch.tensor([pos]))
    assert [int(ours[0][0]), int(ours[1][0])] == np.asarray(key).tolist()
    bits = threefry.random_bits(ours, V)[0].numpy().astype(np.uint32)
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(key, (V,), jnp.uint32)))
    g = threefry.gumbel(ours, V)[0].numpy()
    ref = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
    np.testing.assert_array_equal(g.view(np.uint32), ref.view(np.uint32))


def test_xla_log_over_the_sampler_range():
    """Every uniform the sampler can draw (23 random mantissa bits, plus
    tiny) and its ``-log``: ``xla_log`` gives XLA's bits on both, and
    ``torch.log`` differs from them somewhere (why the port has its own)."""
    bits = torch.arange(2**23, dtype=torch.long) << 9
    u = threefry.uniform_tiny(bits)
    ref_u = np.asarray(jax.jit(jnp.log)(jnp.asarray(u.numpy())))
    ours_u = threefry.xla_log(u)
    np.testing.assert_array_equal(ours_u.numpy().view(np.uint32), ref_u.view(np.uint32))
    x = -ours_u
    ref_x = np.asarray(jax.jit(jnp.log)(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(threefry.xla_log(x).numpy().view(np.uint32),
                                  ref_x.view(np.uint32))
    assert not np.array_equal(torch.log(u).numpy(), ref_u)


@pytest.fixture(scope="module")
def golden():
    """(JAX params, port model, the JAX package's encoder output of golden
    clips 0 and 1) on the golden weights at f32."""
    cfg = W.get_config("test-tiny")
    jp = JQ.fuse_qkv(jax.tree.map(jnp.asarray, _golden_tree()))
    model = Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu")
    model.load_state_dict(load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    mels = [jax_log_mel(jnp.asarray(golden_audio(i)))[None] for i in range(2)]
    xa = np.concatenate([np.array(W.encode(jp, cfg, mel)) for mel in mels])
    return jp, model, xa


def _opts(t: float):
    kw = dict(timestamps=True, word_timestamps=False, max_new_tokens=24, temperature=t)
    return JD.DecodeOptions(**kw), D.DecodeOptions(**kw)


@pytest.mark.parametrize("draft", [False, True], ids=["no_draft", "draft"])
@pytest.mark.parametrize("t,seed", [(0.2, 1), (0.6, 3), (1.0, 5)])
def test_sampled_decode_equals_jax(golden, t, seed, draft):
    jp, model, xa = golden
    jopts, opts = _opts(t)
    prefix, drafted = ([50364, 40485], [50884, 50884, 14567, 7]) if draft else (None, None)
    handle = JD.greedy_decode_dispatch(jp, W.get_config("test-tiny"), jnp.asarray(xa[:1]), jopts,
                                       prefix_tokens=prefix, draft_tokens=drafted, seed=seed)
    ref = np.asarray(handle["packed"])
    plan = D.plan_window(model.cfg, opts, None, prefix, drafted, seed=seed)
    assert plan.aux[D.AUX_TOK + 3] == seed and plan.aux[D.AUX_TEMP] == np.float32(t)
    ours = D._decode_window(model, opts, torch.from_numpy(xa[:1]), torch.from_numpy(plan.aux)[None],
                            plan, (), None, D.DecodeLoop(k=3), captured=False).numpy()
    np.testing.assert_array_equal(ours[: plan.max_new], ref[: plan.max_new])
    assert abs(float(ours[plan.max_new]) - float(ref[plan.max_new])) <= 1e-4 * abs(
        float(ref[plan.max_new])) + 1e-3
    greedy = JD.greedy_decode_dispatch(jp, W.get_config("test-tiny"), jnp.asarray(xa[:1]),
                                       _opts(0.0)[0], prefix_tokens=prefix)
    assert not np.array_equal(np.asarray(greedy["packed"])[: plan.max_new], ref[: plan.max_new])


def test_sampled_batch_equals_jax(golden):
    """Two rows with their own seeds in one sampled loop (temperature 0.8)."""
    jp, model, xa = golden
    jopts, opts = _opts(0.8)
    requests = [{"seed": 11}, {"prefix_tokens": [50364, 40485], "seed": 12}]
    handle = JD.greedy_decode_batch_dispatch(jp, W.get_config("test-tiny"), jnp.asarray(xa),
                                             jopts, requests)
    ref = np.asarray(handle["packed"]).reshape(2, -1)
    plan = D.plan_batch_aux(model.cfg, opts, requests)
    assert [row.aux[D.AUX_TOK + 3] for row in plan.rows] == [11, 12]
    ours = D._decode_window(model, opts, torch.from_numpy(xa), torch.from_numpy(plan.aux), plan,
                            (), None, D.DecodeLoop(), captured=False).numpy().reshape(2, -1)
    np.testing.assert_array_equal(ours[:, : plan.max_new], ref[:, : plan.max_new])


@pytest.fixture(scope="module")
def asrs():
    """(port ASR, JAX ASR) on the golden weights at f32, both capped at 24
    tokens (``tools/golden.py``'s ``build_asr``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden as G

    ours = TorchWhisperASR(cfg=C.get_config("test-tiny"), dtype=torch.float32, device="cpu",
                           params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    ours.transcribe_kargs["max_total_tokens"] = 24
    return ours, G.build_asr()


@pytest.mark.parametrize("beam", [1, 3])
def test_transcribe_with_fallback_equals_jax(asrs, beam, monkeypatch):
    ours, ref = asrs
    keys = []
    loop = ours.decode_loop.loop
    monkeypatch.setattr(ours.decode_loop, "loop", lambda model, key, *a, **k: (
        keys.append(key), loop(model, key, *a, **k))[1])
    for asr in (ours, ref):
        monkeypatch.setattr(asr, "beam_size", beam)
        monkeypatch.setattr(asr, "logprob_threshold", 1e9)  # every rung runs
        monkeypatch.setattr(asr, "_sample_seed", 7)
    audio = golden_audio(0, seconds=3.0)
    got, want = ours.transcribe_with_fallback(audio), ref.transcribe_with_fallback(audio)
    assert got.tokens == want.tokens
    assert [s.text for s in got] == [s.text for s in want]
    assert ours._sample_seed == ref._sample_seed == 7 + 5
    assert not ours.temperature_fallback
    assert len(keys) == 6 and len(set(keys[1:])) == 1  # the first pass, then one rung shape
    assert keys[1].opts.temperature == 1.0 and keys[1].beam_size == 1
    assert keys[0].beam_size == beam


def test_the_ladder_keeps_a_good_result(asrs, monkeypatch):
    """With the default thresholds a result that passes is kept: no rung,
    no seed advance, as the JAX package's."""
    ours, ref = asrs
    for asr in (ours, ref):
        monkeypatch.setattr(asr, "_sample_seed", 0)
        monkeypatch.setattr(asr, "logprob_threshold", -1e9)
        monkeypatch.setattr(asr, "compression_ratio_threshold", 1e9)
    audio = golden_audio(1, seconds=3.0)
    assert ours.transcribe_with_fallback(audio).tokens == ref.transcribe_with_fallback(audio).tokens
    assert ours._sample_seed == ref._sample_seed == 0


def test_long_input_without_previous_text(asrs, monkeypatch):
    """The 40 s input (tools/golden.py's ``long_window``) with
    ``condition_on_previous_text`` off: no window carries a prompt, and the
    tokens equal the JAX package's."""
    ours, ref = asrs
    for asr in (ours, ref):
        monkeypatch.setattr(asr, "condition_on_previous_text", False)
    prompts = []
    window = ours._transcribe_window
    monkeypatch.setattr(ours, "_transcribe_window", lambda *a, prompt_ids=None, **k: (
        prompts.append(prompt_ids), window(*a, prompt_ids=prompt_ids, **k))[1])
    audio = np.concatenate([golden_audio(i) for i in range(5)])
    got, want = ours.transcribe(audio), ref.transcribe(audio)
    assert len(prompts) > 1 and not any(prompts)
    assert [s.text for s in got] == [s.text for s in want]
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]


@pytest.mark.parametrize("clip,seconds", [(0, 8.0), (2, 20.0)])
def test_detect_language_equals_jax(asrs, clip, seconds):
    ours, ref = asrs
    audio = golden_audio(clip, seconds=seconds)
    lang, prob = ours.detect_language(audio)
    ref_lang, ref_prob = ref.detect_language(audio)
    assert lang == ref_lang
    assert abs(prob - ref_prob) < 1e-5
