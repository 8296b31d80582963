"""The port's per-stream device audio ring (``TorchWhisperASR._buffers``), on
the CPU.

- The counterparts of tests/test_decode.py:582 (grow, shift and full: the
  ring equals the s16-quantised audio and is zero past it), :628 (a
  prefetch leaves the tick an aux-only copy, same tokens), :660 (an online
  processor prefetches into its own ``stream_key``) and :677 (periodic
  audio: any verified shift is content-correct).
- The window the log-mel reads, ``ring[:bucket]``, equals the padded window
  the whole-window upload sent, bit for bit.
- A VAC stream's uploads (bench.py's headline loop at test-tiny: EnergyVAD,
  async, policy "last", trimming at 15 s) replayed through the JAX
  package's planner and apply program: the same plan kinds (full, grow and
  shift all occur) and the same ring, bit for bit, after every copy.
- One host→device copy a tick, of the plan's words and the aux bundle.
"""

import os

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.asr import TPUWhisperASR
from realtime_whisper_asr_tpu_torch import asr as A
from realtime_whisper_asr_tpu_torch.models.vad import EnergyVAD
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.streaming import (
    OnlineASRProcessor,
    VACOnlineASRProcessor,
    VADIterator,
)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
SR = 16000
AUX = np.zeros(D.AUX_LEN, np.float32)


@pytest.fixture(scope="module")
def asr():
    asr = A.TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                            params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    return asr


def quantized(audio: np.ndarray) -> np.ndarray:
    return (np.clip(np.round(audio * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


def ring(asr, key) -> np.ndarray:
    return asr._buffers[key][0].numpy()


def _audio(seconds: float, seed: int) -> np.ndarray:
    """tests/test_decode.py's tone in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.1 * rng.standard_normal(t.shape)).astype(
        np.float32)


def synthetic_speech(seconds: float, seed: int = 0) -> np.ndarray:
    """bench.py's headline audio (bench.py:48-55)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.61 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    env = 0.55 * (1 + np.sin(2 * np.pi * 2.7 * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


# ------------------------------------------- tests/test_decode.py's ring cases


def test_upload_planner_grow_shift_full(asr):
    rng = np.random.default_rng(7)
    a = (rng.standard_normal(16000) * 0.2).astype(np.float32)
    b = (rng.standard_normal(8000) * 0.2).astype(np.float32)
    c = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    key = "planner-test"
    asr.set_active_stream(key)
    try:
        assert asr._plan_upload(key, a)["kind"] == "full"
        asr._sync_audio_and_aux(a, AUX)
        assert np.array_equal(ring(asr, key)[: len(a)], quantized(a))
        assert not ring(asr, key)[len(a):].any()

        ab = np.concatenate([a, b])
        assert asr._plan_upload(key, ab)["kind"] == "grow"
        asr._sync_audio_and_aux(ab, AUX)
        assert np.array_equal(ring(asr, key)[: len(ab)], quantized(ab))
        assert not ring(asr, key)[len(ab):].any()

        trimmed = np.concatenate([ab[6000:], c])
        plan = asr._plan_upload(key, trimmed)
        assert plan["kind"] == "shift" and plan["shift_k"] == 6000
        asr._sync_audio_and_aux(trimmed, AUX)
        assert np.array_equal(ring(asr, key)[: len(trimmed)], quantized(trimmed))
        assert not ring(asr, key)[len(trimmed):].any()

        d = (rng.standard_normal(12000) * 0.2).astype(np.float32)
        assert asr._plan_upload(key, d)["kind"] == "full"
        asr._sync_audio_and_aux(d, AUX)
        assert np.array_equal(ring(asr, key)[: len(d)], quantized(d))
        assert not ring(asr, key)[len(d):].any()
        assert ring(asr, key).shape == (asr._CAP,)
    finally:
        asr.drop_stream(key)
        asr.set_active_stream(None)
    assert key not in asr._buffers


def test_prefetch_audio_makes_tick_upload_aux_only(asr):
    key = "prefetch-test"
    audio = _audio(2.0, seed=11)
    assert asr.prefetch_audio(audio, key=key) is True
    plan = asr._plan_upload(key, audio)
    assert plan["kind"] == "grow" and plan["n_new"] == 0 and len(plan["words"]) == 0
    assert asr.prefetch_audio(audio, key=key) is False  # already resident
    longer = np.concatenate([audio, _audio(1.0, seed=12)])
    before = asr.counters["h2d_bytes"]
    assert asr.prefetch_audio(longer, key=key) is True
    assert asr.counters["h2d_bytes"] - before == 2 * SR  # one 1 s bucket of s16 words
    assert np.array_equal(ring(asr, key)[: len(longer)], quantized(longer))
    asr.drop_stream(key)

    ref = asr.transcribe(audio).tokens
    asr.set_active_stream(key)
    try:
        asr.prefetch_audio(audio, key=key)
        before = dict(asr.counters)
        got = asr.transcribe(audio).tokens
        assert asr.counters["h2d_transfers"] - before["h2d_transfers"] == 1
        assert asr.counters["h2d_bytes"] - before["h2d_bytes"] == 4 * D.AUX_LEN
    finally:
        asr.drop_stream(key)
        asr.set_active_stream(None)
    assert got == ref


def test_online_insert_prefetches_to_stream_key(asr):
    online = OnlineASRProcessor(asr)
    online.stream_key = "sid-42"
    asr.set_active_stream("sid-other")
    try:
        chunk = _audio(1.0, seed=13)
        online.insert_audio_chunk(chunk)
        assert "sid-42" in asr._buffers and "sid-other" not in asr._buffers
        assert np.array_equal(asr._buffers["sid-42"][1], chunk)
    finally:
        asr.drop_stream("sid-42")
        asr.set_active_stream(None)


def test_shift_detection_on_periodic_audio(asr):
    key = "periodic-test"
    asr.set_active_stream(key)
    try:
        tone = np.tile(np.sin(np.linspace(0, 2 * np.pi, 160, endpoint=False)), 200).astype(
            np.float32)
        asr._sync_audio_and_aux(tone, AUX)
        trimmed = tone[4800:]  # a whole number of periods: many candidates, all correct
        assert asr._plan_upload(key, trimmed)["kind"] in ("shift", "grow", "full")
        asr._sync_audio_and_aux(trimmed, AUX)
        assert np.array_equal(ring(asr, key)[: len(trimmed)], quantized(trimmed))
        assert not ring(asr, key)[len(trimmed):].any()
    finally:
        asr.drop_stream(key)
        asr.set_active_stream(None)


# --------------------------------------------- the window, and the dispatch


@pytest.mark.parametrize("seconds", [0.5, 1.0, 7.99, 8.0, 8.01, 15.3, 16.0, 29.0, 30.0, 31.0])
def test_ring_window_equals_the_padded_upload(asr, seconds):
    """Grown from a 0.5 s start in uneven pieces, the ring's first window
    bucket is the window the whole-window upload sent: the padded audio as
    s16 words, back to samples."""
    audio = synthetic_speech(seconds, seed=int(seconds * 10))
    key = ("window", seconds)
    for end in sorted({min(len(audio), n) for n in (8000, 8000 + 12345, 70000, len(audio))}):
        asr.prefetch_audio(audio[:end], key=key)
    bucket = asr._window_bucket(min(len(audio), A.WINDOW_SAMPLES))
    old = A._words_to_samples(torch.from_numpy(A._samples_to_words(asr._pad_window(audio))))
    got = asr._buffers[key][0][:bucket]
    asr.drop_stream(key)
    assert got.shape == old.shape and torch.equal(got, old)


def test_dispatch_key_selects_the_ring_and_restores_the_active_stream(asr):
    audio = _audio(2.0, seed=21)
    asr.set_active_stream("active")
    try:
        ref = asr.transcribe_finalize(asr.transcribe_dispatch(audio)).tokens
        got = asr.transcribe_finalize(asr.transcribe_dispatch(audio, key="other")).tokens
        assert asr._active_stream == "active" and "other" in asr._buffers
        assert np.array_equal(asr._buffers["other"][1], audio)
        assert got == ref
    finally:
        for key in ("active", "other"):
            asr.drop_stream(key)
        asr.set_active_stream(None)


# ------------------------------------------ a VAC stream against the JAX ring


def _jax_ring_holder():
    """The JAX package's ASR with only what its planner and apply program
    read: the per-stream buffers and the counters."""
    ref = object.__new__(TPUWhisperASR)
    ref._buffers, ref._active_stream = {}, None
    ref.counters = {"h2d_transfers": 0, "h2d_bytes": 0}
    return ref


@pytest.fixture(scope="module")
def headline_stream(asr):
    """bench.py's headline loop at test-tiny, one run of 24 s at 1 s chunks.
    Each copy is replayed at once through the JAX package's planner and
    apply program: per copy (the port's plan, the JAX plan's kind, whether
    the two rings are equal bit for bit, whether the port's is zero past its
    audio); per tick, the copies made inside its dispatch."""
    copies, ticks = [], []
    ref = _jax_ring_holder()
    apply, dispatch = asr._upload_and_apply, asr._transcribe_window_dispatch

    def replaying_apply(keys, plans, aux_rows):
        out = apply(keys, plans, aux_rows)
        (key,), (plan,) = keys, plans
        ref_plan = ref._plan_upload(key, plan["mirror"])
        ref._upload_and_apply([key], [ref_plan], aux_rows)
        ring_, n = asr._buffers[key][0].numpy(), len(plan["mirror"])
        copies.append({"plan": plan, "aux": aux_rows is not None, "ref_kind": ref_plan["kind"],
                       "same_words": np.array_equal(ref_plan["words"].view(np.int16),
                                                    plan["words"].view(np.int16)),
                       "same_ring": np.array_equal(ring_, np.asarray(ref._buffers[key][0])),
                       "zero_tail": not ring_[n:].any()})
        return out

    def counting_dispatch(audio, *args, **kwargs):
        before = (len(copies), asr.counters["h2d_transfers"], asr.counters["h2d_bytes"])
        out = dispatch(audio, *args, **kwargs)
        ticks.append({"copies": len(copies) - before[0],
                      "transfers": asr.counters["h2d_transfers"] - before[1],
                      "bytes": asr.counters["h2d_bytes"] - before[2],
                      "window_bytes": 2 * asr._window_bucket(len(audio)) + 4 * D.AUX_LEN})
        return out

    asr._upload_and_apply, asr._transcribe_window_dispatch = replaying_apply, counting_dispatch
    saved = asr.max_tokens_per_second
    asr.max_tokens_per_second = 4.0
    try:
        vac = VACOnlineASRProcessor(
            OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0), prefix_policy="last",
                               pipeline="async"),
            VADIterator(EnergyVAD(), min_silence_duration_ms=500), online_chunk_size=0.5)
        audio = synthetic_speech(32.0)[: 24 * SR]
        for pos in range(0, len(audio), SR):
            vac.insert_audio_chunk(audio[pos : pos + SR])
            vac.process_iter()
        vac.finish()
    finally:
        del asr._upload_and_apply, asr._transcribe_window_dispatch
        asr.max_tokens_per_second = saved
    return copies, ticks


def test_vac_stream_plans_and_rings_equal_the_jax_packages(headline_stream):
    copies, _ = headline_stream
    kinds = [c["plan"]["kind"] for c in copies]
    assert kinds == [c["ref_kind"] for c in copies]
    assert {"full", "grow", "shift"} <= set(kinds), kinds
    assert all(c["same_words"] and c["same_ring"] and c["zero_tail"] for c in copies)


def test_trims_and_restarts_equal_the_jax_ring():
    """A buffer grown by uneven pieces, trimmed at seeded points and
    restarted twice, planned and applied by both packages: the same kinds,
    the aux words back unchanged, the same ring after each copy."""
    audio = synthetic_speech(32.0)[: 24 * SR]
    ours = A.TorchWhisperASR.__new__(A.TorchWhisperASR)  # only the ring's state
    ours._buffers, ours._active_stream, ours.device = {}, None, torch.device("cpu")
    ours.counters = {"h2d_transfers": 0, "h2d_bytes": 0}
    ref = _jax_ring_holder()
    buf = np.zeros(0, np.float32)
    rng = np.random.default_rng(3)
    kinds = set()
    for step in range(40):
        if step in (13, 29):
            buf = audio[step * SR : step * SR + 8000]
        elif step % 5 == 4 and len(buf) > 2 * SR:
            cut = int(rng.integers(SR // 2, len(buf) // 2))
            buf = np.concatenate([buf[cut:], audio[step * SR : step * SR + SR]])
        else:
            buf = np.concatenate([buf, audio[step * 9000 % len(audio):][:9000]])
        buf = buf[: A.WINDOW_SAMPLES]
        plan, ref_plan = ours._plan_upload(None, buf), ref._plan_upload(None, buf)
        assert plan["kind"] == ref_plan["kind"], step
        kinds.add(plan["kind"])
        aux = np.full((1, D.AUX_LEN), step, np.float32)
        aux_dev = ours._upload_and_apply([None], [plan], aux)
        ref._upload_and_apply([None], [ref_plan], aux)
        assert np.array_equal(aux_dev.numpy(), aux.reshape(-1))
        assert np.array_equal(ours._buffers[None][0].numpy(), np.asarray(ref._buffers[None][0]))
    assert kinds == {"full", "grow", "shift"}


def test_one_copy_per_tick(headline_stream):
    """Each tick's dispatch makes one host→device copy, of the plan's words
    and the aux bundle; after the insert's prefetch the words are empty, so
    a tick moves the aux bundle only, and a prefetch moves the new suffix
    (a chunk bucket), not the window."""
    copies, ticks = headline_stream
    assert len(ticks) >= 20
    assert all(t["copies"] == 1 and t["transfers"] == 1 for t in ticks), ticks
    assert all(t["bytes"] == 4 * D.AUX_LEN for t in ticks), ticks
    assert sum(not c["aux"] for c in copies) + len(ticks) == len(copies)
    moved = sum(4 * len(c["plan"]["words"]) for c in copies) + 4 * D.AUX_LEN * len(ticks)
    assert moved < sum(t["window_bytes"] for t in ticks)
