"""The port's pipelined ticks: the decode's dispatch/finalize split, the
device-side draft and the pipelined streaming loop, on the CPU at f32.

- ``decode.patch_aux_device_draft`` equals the JAX package's bit for bit
  (the reference's own cases, and seeded random packed rows at B = 1 and 2),
  and a forced device draft decodes token for token as the JAX package's
  ``greedy_decode_dispatch(aux_device=patched, force_draft_bucket=True)``.
- ``greedy_decode_finalize(greedy_decode_dispatch(...))`` equals
  ``greedy_decode``, and the handle's packed result shares no storage with
  the loop's state (the next window refills that state while an async tick
  still holds the handle).
- ``OnlineASRProcessor(pipeline=True | "async")`` reproduces the golden
  ``pipeline_exact`` and ``pipeline_async`` rows and the sync commits under
  ``prefix_policy="last"`` (tools/golden.py); exact equals sync with the
  first call empty; a poisoned handle resets the stream and the loop
  recovers; async is deterministic, time-ordered and survives a trim;
  ``set_pipeline`` and ``state_dict`` drain the in-flight tick.
- ``TorchWhisperASR._density_cap`` equals the reference's arithmetic, and
  with ``max_tokens_per_second=None`` the uploaded aux is the plan's.
"""

import ast
import dataclasses
import inspect
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.asr import TPUWhisperASR
from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import decode as JD
from realtime_whisper_asr_tpu.models.whisper import quant as JQ
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram as jax_log_mel
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
SR = 16000
EOT = get_config("test-tiny").eot


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """tools/golden.py's deterministic synthetic clips."""
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


def _audio(seconds: float, seed: int) -> np.ndarray:
    """tests/test_decode.py's tone in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.1 * rng.standard_normal(t.shape)).astype(
        np.float32)


@pytest.fixture(scope="module")
def recorded():
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        return json.load(f)["matrix"]


@pytest.fixture(scope="module")
def asr():
    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    return asr


# ------------------------------------------------------ patch_aux_device_draft


def _patch_both(aux: np.ndarray, packed: np.ndarray, offset: int, max_new: int, row_len: int,
                **kw) -> tuple[np.ndarray, np.ndarray]:
    """(the JAX package's patched aux, the port's) on the same inputs."""
    ref = np.asarray(JD.patch_aux_device_draft(jnp.asarray(aux), jnp.asarray(packed), offset,
                                               prev_max_new=max_new, prev_row_len=row_len,
                                               eot=EOT, **kw))
    ours = torch.from_numpy(aux.copy())
    D.patch_aux_device_draft(ours, torch.from_numpy(packed), offset, max_new, row_len, EOT, **kw)
    return ref, ours.numpy()


# tests/test_decode.py::test_patch_aux_device_draft_slices_and_signs: (offset,
# force, the signed length and the draft it must give)
_REFERENCE_CASES = [
    (2, False, 6, [103, 104, 105, 106, 107, EOT]),
    (2, True, -3, [103, 104, 105]),
    (9, False, 0, []),
    (9, True, 0, []),
]


@pytest.mark.parametrize("offset,force,n_draft,draft", _REFERENCE_CASES,
                         ids=["verify_off2", "forced_off2", "verify_off9", "forced_off9"])
def test_patch_aux_device_draft_equals_jax_on_its_cases(offset, force, n_draft, draft):
    max_new, row_len = 12, 20
    row = np.zeros(row_len, np.float32)
    row[:max_new] = [101, 102, 103, 104, 105, 106, 107, EOT, 0, 0, 0, 0]
    aux = np.zeros((1, D.AUX_LEN), np.float32)
    ref, ours = _patch_both(aux, row, offset, max_new, row_len, force=force, safety=2)
    assert np.array_equal(ours, ref)
    assert ours[0, D.AUX_TOK + 5] == n_draft
    slots = ours[0, D.AUX_TOK + 6 : D.AUX_TOK + 6 + D.DRAFT_MAX]
    assert list(slots[: len(draft)].astype(int)) == draft
    assert not slots[len(draft) :].any()


@pytest.mark.parametrize("force", [False, True], ids=["verify", "forced"])
@pytest.mark.parametrize("b", [1, 2])
def test_patch_aux_device_draft_equals_jax_on_random_rows(b, force):
    """Seeded packed rows (tokens, an EOT at a random place or none, then
    sum logprob, no-speech probability and capture words) and a planned aux
    bundle, patched at offsets inside, at the edges of and past the sampled
    region: the port's aux equals the reference's bit for bit."""
    rng = np.random.default_rng(11 + b)
    max_new, row_len = 48, 48 + 2 + 40
    for trial in range(6):
        packed = rng.standard_normal((b, row_len)).astype(np.float32)
        packed[:, :max_new] = rng.integers(0, EOT, (b, max_new))
        for r in range(b):
            if trial % 3:  # EOT somewhere, then EOT fill as the loop leaves it
                at = int(rng.integers(0, max_new))
                packed[r, at:max_new] = EOT
        aux = np.stack([D.plan_window(get_config("test-tiny"), D.DecodeOptions(), None,
                                      list(rng.integers(0, 5000, 3 + r)),
                                      list(rng.integers(0, 5000, 5))).aux for r in range(b)])
        for offset in (0, 1, 7, max_new - 1, max_new + 3, -2):
            ref, ours = _patch_both(aux, packed.reshape(-1), offset, max_new, row_len,
                                    force=force, safety=int(rng.integers(0, 6)))
            assert np.array_equal(ours, ref), (trial, offset)


# ------------------------------------------------------------ the decode split


def _golden_tree() -> dict:
    tree: dict = {}
    with np.load(os.path.join(GOLDEN, "params.npz")) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key].astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def golden_xa():
    """(JAX params, encoder output of tests/test_decode.py's 4 s tone), the
    encoder output from the JAX package, fed to both decoders."""
    params = JQ.fuse_qkv(jax.tree.map(jnp.asarray, _golden_tree()))
    mel = jax_log_mel(jnp.asarray(_audio(4.0, seed=7)))[None]
    return params, np.array(W.encode(params, W.get_config("test-tiny"), mel))


@pytest.mark.parametrize("force", [True, False], ids=["forced", "verified"])
def test_device_draft_decodes_as_jax(asr, golden_xa, force):
    """tests/test_decode.py::test_forced_device_draft_tokens_are_kept on the
    port: a first decode's sampled tokens 1.. become the second decode's
    device draft, forced (minus a safety tail of 2) or verified; the second
    decode equals the JAX package's token for token, and forced tokens
    appear verbatim."""
    params, xa = golden_xa
    cfg = W.get_config("test-tiny")
    jopts = JD.DecodeOptions(timestamps=True, word_timestamps=False, max_new_tokens=24)
    opts = D.DecodeOptions(timestamps=True, word_timestamps=False, max_new_tokens=24)
    patch = dict(force=force, safety=2)

    # both sides decode from the port's planned aux bundles (the cap of 24
    # rides in them)
    plan0 = D.plan_window(asr.cfg, opts)
    plan = D.plan_window(asr.cfg, opts, force_draft_bucket=True)
    assert plan.draft_max == D.DRAFT_MAX and plan.aux[D.AUX_TOK + 5] == 0
    h0 = JD.greedy_decode_dispatch(params, cfg, jnp.asarray(xa), jopts,
                                   aux_device=jnp.asarray(plan0.aux))
    jpatched = JD.patch_aux_device_draft(
        jnp.asarray(plan.aux)[None], h0["packed"], 1, prev_max_new=h0["max_new"],
        prev_row_len=int(h0["packed"].size), eot=cfg.eot, **patch)
    ref = JD.greedy_decode_finalize(JD.greedy_decode_dispatch(
        params, cfg, jnp.asarray(xa), jopts, aux_device=jpatched, force_draft_bucket=True))

    xat = torch.from_numpy(xa)
    first = D.greedy_decode_dispatch(asr.model, xat, opts, plan0, torch.from_numpy(plan0.aux))
    toks = slice(0, plan0.max_new)
    assert np.array_equal(first.packed.numpy()[toks], np.asarray(h0["packed"])[toks])
    aux = torch.from_numpy(plan.aux.copy())[None]
    D.patch_aux_device_draft(aux, first.packed, 1, plan0.max_new, first.packed.numel(),
                             asr.cfg.eot, **patch)
    assert np.array_equal(aux.numpy(), np.asarray(jpatched))
    got = D.greedy_decode_finalize(D.greedy_decode_dispatch(asr.model, xat, opts, plan, aux))

    n = int(ref.lengths[0])
    assert int(got.lengths[0]) == n
    assert got.tokens[0][:n].tolist() == ref.tokens[0][:n].tolist()
    n_draft = int(abs(aux[0, D.AUX_TOK + 5]))
    assert n_draft > 0
    if force:
        toks0 = D.greedy_decode_finalize(first).tokens[0].tolist()
        assert got.tokens[0][:n_draft].tolist() == toks0[1 : 1 + n_draft]


def test_dispatch_then_finalize_equals_greedy_decode(asr, golden_xa, monkeypatch):
    """finalize(dispatch) gives greedy_decode's result bit for bit (with the
    capture and a host draft), and the handle's packed result is a buffer of
    its own: it shares no storage with the loop state, and wiping that state
    after the dispatch changes nothing the finalize reads."""
    xa = torch.from_numpy(golden_xa[1])
    opts = D.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=24)
    first = D.greedy_decode(asr.model, xa, opts, D.plan_window(asr.cfg, opts),
                            torch.from_numpy(D.plan_window(asr.cfg, opts).aux))
    ids = first.tokens[0][: first.lengths[0]].tolist()
    plan = D.plan_window(asr.cfg, opts, None, ids[:3], ids[3:8] + [5, 7])
    aux = torch.from_numpy(plan.aux)
    ref = D.greedy_decode(asr.model, xa, opts, plan, aux)

    states = []
    pack = D._pack

    def recording_pack(st, *args):
        states.append(st)
        return pack(st, *args)

    monkeypatch.setattr(D, "_pack", recording_pack)
    handle = D.greedy_decode_dispatch(asr.model, xa, opts, plan, aux)
    (st,) = states
    tensors = [getattr(st.cache, f.name) for f in dataclasses.fields(st.cache)]
    tensors += [getattr(st, f.name) for f in dataclasses.fields(st)][1:]
    own = handle.packed.untyped_storage().data_ptr()
    assert all(own != t.untyped_storage().data_ptr() for t in tensors if t is not None)
    with torch.inference_mode():
        for t in tensors:
            if t is not None:
                t.zero_()
    got = D.greedy_decode_finalize(handle)
    for field in dataclasses.fields(D.DecodeResult):
        assert np.array_equal(getattr(got, field.name), getattr(ref, field.name)), field.name


def _host_reads(func) -> list[str]:
    """Calls in ``func``'s source that read a device value on the host."""
    out = []
    for n in ast.walk(ast.parse(inspect.getsource(func))):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in ("item", "tolist", "cpu", "numpy",
                                                          "synchronize"):
                out.append(f.attr)
            if (isinstance(f, ast.Name) and f.id in ("bool", "int", "float")
                    and not isinstance(n.args[0], ast.Constant)):
                out.append(f.id)
    return out


def test_the_split_reads_the_device_only_in_the_finalize_wait():
    """The device draft and the dispatch's copy read nothing back; the
    finalize's one wait is the copy's event (the loop's end is waited for
    only under a phase timer), then the pinned host buffer is read."""
    assert _host_reads(D.patch_aux_device_draft) == []
    assert _host_reads(D._copy_to_host) == []
    assert _host_reads(D.greedy_decode_dispatch) == []
    assert sorted(_host_reads(D.greedy_decode_finalize)) == ["numpy", "synchronize",
                                                              "synchronize"]


# ------------------------------------------------------------- the stream loop


def _stream(asr, audio, pipeline, **kw):
    """(processor, each call's return, finish's) over 1 s chunks."""
    proc = OnlineASRProcessor(asr, pipeline=pipeline, **kw)
    outs = []
    for pos in range(0, len(audio), SR):
        proc.insert_audio_chunk(audio[pos : pos + SR])
        outs.append(proc.process_iter())
    outs.append(proc.finish())
    return proc, outs


def _commits(proc) -> list:
    return [[round(float(b), 3), round(float(e), 3), w] for b, e, w in proc.commited]


@pytest.fixture(scope="module")
def golden_streams(asr):
    """tools/golden.py's pipelined rows on the port: each clip streamed
    synchronously, exact and async, prefix policy "last"."""
    out = {}
    for idx in range(3):
        audio = golden_audio(idx)
        for mode in (False, True, "async"):
            proc, _ = _stream(asr, audio, mode, buffer_trimming=("segment", 15.0),
                              prefix_policy="last")
            out[idx, mode] = _commits(proc)
    return out


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_golden_sync_commits_under_policy_last(recorded, golden_streams, idx):
    assert golden_streams[idx, False] == recorded["pipeline_async"]["sync_commits"][idx]


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_golden_pipeline_exact_row(recorded, golden_streams, idx):
    assert recorded["pipeline_exact"]["matches_sync"]
    assert golden_streams[idx, True] == recorded["pipeline_exact"]["commits"][idx]
    assert golden_streams[idx, True] == golden_streams[idx, False]


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_golden_pipeline_async_row(recorded, golden_streams, idx):
    assert golden_streams[idx, "async"] == recorded["pipeline_async"]["commits"][idx]


def test_pipelined_online_matches_sync(asr):
    """tests/test_decode.py::test_pipelined_online_matches_sync on the port:
    exact mode commits what the sync loop commits, one call later (the
    first call returns nothing; finish() drains the last tick)."""
    audio = _audio(6.0, seed=3)
    proc_s, sync = _stream(asr, audio, False, buffer_trimming=("segment", 4.0))
    proc_p, piped = _stream(asr, audio, True, buffer_trimming=("segment", 4.0))
    join = lambda outs: asr.sep.join(t for _, _, t in outs if t)  # noqa: E731
    assert join(piped) == join(sync)
    assert proc_p.commited == proc_s.commited
    assert piped[0] == (None, None, "")


def test_pipelined_online_survives_a_poisoned_handle(asr, caplog):
    """tests/test_decode.py::test_pipelined_online_survives_dispatch_error on
    the port: a finalize that raises resets the stream state (logged), and
    the loop goes on taking audio."""
    proc = OnlineASRProcessor(asr, buffer_trimming=("segment", 4.0), pipeline=True)
    audio = _audio(3.0, seed=4)
    proc.insert_audio_chunk(audio[:SR])
    proc.process_iter()
    assert proc._inflight is not None
    _, t0, off0 = proc._inflight
    proc._inflight = ({"decode_handle": None, "prefix_ids": None, "audio_len": 0,
                       "time_offset": 0.0}, t0, off0)
    proc.insert_audio_chunk(audio[SR : 2 * SR])
    assert proc.process_iter()[2] == ""
    assert "pipelined finalize failed" in caplog.text
    assert proc._inflight is not None  # this tick was dispatched after the reset
    proc.insert_audio_chunk(audio[2 * SR :])
    proc.process_iter()
    proc.finish()
    assert proc._inflight is None


def test_async_pipelined_online_deterministic(asr):
    """tests/test_decode.py::test_async_pipelined_online_deterministic on the
    port: two async runs commit the same words, in time order, and the
    buffer was trimmed (a trim between a tick's dispatch and its apply
    shifts the stale result by the offset it was decoded against)."""
    audio = _audio(10.0, seed=5)
    p1, o1 = _stream(asr, audio, "async", buffer_trimming=("segment", 4.0))
    p2, o2 = _stream(asr, audio, "async", buffer_trimming=("segment", 4.0))
    assert [o[2] for o in o1] == [o[2] for o in o2]
    assert p1.commited == p2.commited
    starts = [w[0] for w in p1.commited]
    assert starts == sorted(starts)
    assert any(t for _, _, t in o1), "async pipeline transcribed nothing"
    assert p1.buffer_time_offset > 0.0


def test_async_ticks_dispatch_with_a_device_draft(asr, monkeypatch):
    """In async mode, once a tick has a prefix and a previous tick is in
    flight, the dispatch reads that tick's packed result as its draft."""
    drafts = []
    dispatch = asr.transcribe_dispatch

    def recording(*args, device_draft=None, **kw):
        drafts.append(device_draft)
        return dispatch(*args, device_draft=device_draft, **kw)

    monkeypatch.setattr(asr, "transcribe_dispatch", recording)
    _stream(asr, golden_audio(0), "async", prefix_policy="last")
    used = [d for d in drafts if d is not None]
    assert drafts[0] is None and used
    for d in used:
        assert d["force"] and d["safety"] == 4 and d["offset"] >= 0
        assert d["row_len"] == d["packed"].numel()  # one row


# --------------------------------------------------- draining, with a fake ASR


def timecoded_audio(t0: float, t1: float) -> np.ndarray:
    """tests/test_streaming.py's audio: sample k holds k/SR * 1e-3."""
    k = np.arange(int(t0 * SR), int(t1 * SR))
    return (k / SR * 1e-3).astype(np.float32)


class DispatchingFakeASR:
    """tests/test_streaming.py's TimecodedFakeASR with the dispatch/finalize
    protocol: serves the ground-truth words inside the buffer's window (read
    back from the audio's values); the "device" result is computed at the
    dispatch."""

    sep = ""

    def __init__(self, words):
        self.words = words

    def transcribe(self, audio, init_prompt=""):
        if len(audio) == 0:
            return []
        t0 = float(audio[0]) * 1e3
        t1 = t0 + len(audio) / SR
        return [(b - t0, e - t0, w) for b, e, w in self.words
                if b >= t0 - 1e-6 and e <= t1 + 1e-6]

    def transcribe_dispatch(self, audio, init_prompt="", prefix_ids=None, draft_ids=None,
                            device_draft=None):
        return {"res": self.transcribe(audio, init_prompt)}

    def transcribe_finalize(self, st):
        return st["res"]

    def ts_words(self, segments):
        return segments

    def segments_end_ts(self, segments):
        return [e for _, e, _ in segments]


WORDS = [(0.2, 0.6, " a"), (0.7, 1.1, " b"), (1.2, 1.6, " c")]


def test_set_pipeline_drains_inflight():
    """tests/test_streaming.py::test_set_pipeline_drains_inflight on the
    port: switching modes mid-session drains the in-flight tick and hands
    its commit back; an ASR without the dispatch protocol never pipelines."""
    proc = OnlineASRProcessor(DispatchingFakeASR(WORDS), pipeline="async")
    outs = []
    for t in range(3):
        proc.insert_audio_chunk(timecoded_audio(t, t + 1.0))
        outs.append(proc.process_iter())
    assert proc._inflight is not None
    drained = proc.set_pipeline(False)
    assert proc._inflight is None and proc.pipeline is False
    text = "".join(txt for _, _, txt in outs + [drained, proc.finish()] if txt)
    assert "a" in text and "b" in text and "c" in text
    assert proc.set_pipeline(False) == (None, None, "")
    fake = DispatchingFakeASR(WORDS)
    plain = types.SimpleNamespace(sep="", transcribe=fake.transcribe, ts_words=fake.ts_words,
                                  segments_end_ts=fake.segments_end_ts)
    proc2 = OnlineASRProcessor(plain, pipeline="async")
    assert proc2.pipeline is False
    proc2.set_pipeline("async")
    assert proc2.pipeline is False


def test_pipeline_env_default(monkeypatch):
    fake = DispatchingFakeASR(WORDS)
    for env, mode in (("", False), ("0", False), ("1", True), ("exact", True),
                      ("async", "async")):
        monkeypatch.setenv("RWA_PIPELINE", env)
        assert OnlineASRProcessor(fake).pipeline == mode
    assert OnlineASRProcessor(fake, pipeline=False).pipeline is False


@pytest.mark.parametrize("mode", [True, "async"], ids=["exact", "async"])
def test_state_dict_drains_an_inflight_tick(mode):
    proc = OnlineASRProcessor(DispatchingFakeASR(WORDS), pipeline=mode)
    for t in range(3):
        proc.insert_audio_chunk(timecoded_audio(t, t + 1.0))
        proc.process_iter()
    before = list(proc.commited)
    assert proc._inflight is not None
    state = proc.state_dict()
    assert proc._inflight is None
    assert state["commited"] == proc.commited and len(proc.commited) > len(before)


def test_exact_state_dict_equals_the_sync_loops(asr):
    """The snapshot of an exact-mode stream, its in-flight tick drained,
    equals the synchronous stream's after the same chunks."""
    audio = golden_audio(1, seconds=4.0)
    states = []
    for mode in (False, True):
        proc = OnlineASRProcessor(asr, prefix_policy="last", pipeline=mode)
        for pos in range(0, len(audio), SR):
            proc.insert_audio_chunk(audio[pos : pos + SR])
            proc.process_iter()
        states.append(proc.state_dict())
    sync, exact = states
    assert np.array_equal(sync.pop("audio_buffer"), exact.pop("audio_buffer"))
    assert sync == exact


# -------------------------------------------------------------- density cap


@pytest.mark.parametrize("rate", [None, 1.0, 4.0, 7.5])
def test_density_cap_equals_the_reference(rate):
    ours = types.SimpleNamespace(max_tokens_per_second=rate)
    for cap in (1, 24, 224):
        for n_prefix in (0, 10, 40):
            for samples in (SR // 2, SR, 8 * SR + 123, 30 * SR):
                ref = TPUWhisperASR._density_cap(ours, cap, n_prefix, samples)
                assert TorchWhisperASR._density_cap(ours, cap, n_prefix, samples) == ref


def test_dispatch_applies_the_density_cap(asr, monkeypatch):
    """The uploaded aux is the plan's when the rate is None; with a rate its
    cap slot holds the density cap, and the decode stops there."""
    uploads = []
    upload = asr._upload

    def recording(audio, aux):
        uploads.append(aux.copy())
        return upload(audio, aux)

    monkeypatch.setattr(asr, "_upload", recording)
    audio = golden_audio(2, seconds=2.0)
    prefix = asr.transcribe(audio).tokens[:3]
    res = asr.transcribe(audio, prefix_ids=prefix)
    plan = D.plan_window(asr.cfg, asr._make_opts(), None, prefix)
    assert np.array_equal(uploads[-1], plan.aux)
    monkeypatch.setattr(asr, "max_tokens_per_second", 1.5)
    capped = asr.transcribe(audio, prefix_ids=prefix)
    cap = int(8 + 1.5 * 2) - len(prefix)
    assert uploads[-1][D.AUX_TOK + 4] == cap < plan.aux[D.AUX_TOK + 4]
    assert np.array_equal(np.delete(uploads[-1], D.AUX_TOK + 4), np.delete(plan.aux, D.AUX_TOK + 4))
    assert len(capped.tokens) == len(prefix) + cap < len(res.tokens)


def test_a_long_input_is_dispatched_synchronously(asr):
    """Input over 30 s is windowed at the dispatch, as ``transcribe`` does,
    and the finalize hands back that result."""
    audio = np.concatenate([golden_audio(0, seconds=16.0), golden_audio(1, seconds=16.0)])
    handle = asr.transcribe_dispatch(audio)
    assert set(handle) == {"sync_result"}
    got, ref = asr.transcribe_finalize(handle), asr.transcribe(audio)
    assert [(s.start, s.end, s.text) for s in got] == [(s.start, s.end, s.text) for s in ref]
