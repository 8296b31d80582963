"""The port's StreamServer over the port's real ASR (test-tiny, CPU).

- ``tests/test_serving_integration.py``'s batched-pipelined and
  mixed-language cases, on the port's ``TorchWhisperASR`` (random test-tiny
  weights, 12-token caps): per-stream rings keyed by stream id, batched and
  pipelined dispatch/finalize through the real decode, language groups.
- Parity: 3 streams over the golden clips (golden weights at f32,
  ``use_vad=False``, ``prefix_policy="last"``, pipelined) commit the same
  words per stream through the JAX package's server on its ASR and the
  port's on the port's. A constant clock keeps load shedding out of both.
- VAC with the default VAD factory: N streams share ONE Silero-like net
  (on the ASR's device), each VAD with its own LSTM state.
"""

import os
import sys

import numpy as np
import pytest
import torch

import realtime_whisper_asr_tpu.serving as JS
import realtime_whisper_asr_tpu_torch.serving as PS
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000


def _audio(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.1 * rng.standard_normal(t.shape)).astype(
        np.float32)


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
def asr():
    a = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu")
    a.transcribe_kargs.update(max_new_tokens=12, max_total_tokens=12)
    return a


def _run(server, sids, seconds=4):
    outs = {sid: [] for sid in sids}
    for t in range(seconds):
        for i, sid in enumerate(sids):
            server.feed(sid, _audio(1.0, seed=100 * i + t))
        while server.step():
            pass
        for sid in sids:
            outs[sid].extend(server.poll(sid))
    for sid in sids:
        outs[sid].extend(server.close_stream(sid))
    return outs


def test_real_backend_batched_pipelined_streams(asr):
    """Two same-language streams ride one batched and pipelined decode group
    through the real decode; state stays per stream (rings keyed by id)."""
    server = PS.StreamServer(asr, use_vad=False, online_chunk_size=0.5, prefix_policy="last")
    sizes = []
    dispatch = asr.transcribe_batch_dispatch

    def recording(items):
        sizes.append(len(items))
        return dispatch(items)

    asr.transcribe_batch_dispatch = recording
    try:
        sids = [server.create_stream(), server.create_stream()]
        outs = _run(server, sids)
    finally:
        del asr.transcribe_batch_dispatch
    assert 2 in sizes, sizes
    assert server.get_stats()["total_streams"] == 0
    assert server.group_failures == 0
    assert not any(sid in asr._buffers for sid in sids)  # dropped at close
    for sid in sids:
        for r in outs[sid]:
            assert r.stream_id == sid
            assert r.end >= r.begin >= 0.0


def test_real_backend_mixed_language_groups(asr):
    """en + zh streams form separate pipelined groups; both decode without
    cross-talk in the shared ASR's language state."""
    server = PS.StreamServer(asr, use_vad=False, online_chunk_size=0.5)
    a = server.create_stream(language="en")
    b = server.create_stream(language="zh")
    langs = []
    dispatch = asr.transcribe_batch_dispatch

    def recording(items):
        langs.append((tuple(it["key"] for it in items), asr.original_language))
        return dispatch(items)

    asr.transcribe_batch_dispatch = recording
    try:
        outs = _run(server, [a, b], seconds=3)
    finally:
        del asr.transcribe_batch_dispatch
    assert {((a,), "en"), ((b,), "zh")} <= set(langs), langs
    assert server.get_stats()["total_streams"] == 0 and server.group_failures == 0
    assert all(r.stream_id == a for r in outs[a])
    assert all(r.stream_id == b for r in outs[b])


def _serve_golden(S, asr) -> list[list[str]]:
    server = S.StreamServer(asr, use_vad=False, online_chunk_size=0.5, prefix_policy="last",
                            clock=lambda: 0.0)
    clips = [golden_audio(i) for i in range(3)]
    sids = [server.create_stream() for _ in clips]
    outs = {sid: [] for sid in sids}
    for pos in range(0, len(clips[0]), SR):
        for sid, clip in zip(sids, clips):
            server.feed(sid, clip[pos : pos + SR])
        while server.step():
            pass
        for sid in sids:
            outs[sid].extend(r.text for r in server.poll(sid))
    for sid in sids:
        outs[sid].extend(r.text for r in server.close_stream(sid))
    assert server.group_failures == 0
    return [outs[sid] for sid in sids]


def test_server_commits_the_jax_servers_words():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden as G

    ours = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                           params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    ours.transcribe_kargs["max_total_tokens"] = 24  # as build_asr
    got = _serve_golden(PS, ours)
    assert got == _serve_golden(JS, G.build_asr())
    assert all(got), got


def test_vac_streams_share_one_vad_net(asr):
    server = PS.StreamServer(asr, use_vad=True, online_chunk_size=0.5)
    sids = [server.create_stream() for _ in range(3)]
    vads = [server.streams[sid].processor.vac.prob_fn for sid in sids]
    assert all(isinstance(v, SileroLikeVAD) for v in vads)
    assert len({id(v.net) for v in vads}) == 1
    assert vads[0].net.window.device == asr.device
    assert len({id(v.state[1]) for v in vads}) == 3  # each its own LSTM state
    silence = np.zeros(SR, np.float32)
    for t in range(3):
        for i, sid in enumerate(sids):
            server.feed(sid, _audio(1.0, seed=7 * i + t) if i else silence)
        while server.step():
            pass
    assert not torch.equal(vads[0].state[1], vads[1].state[1])
    for sid in sids:
        server.close_stream(sid)
    assert server.get_stats()["total_streams"] == 0 and server.group_failures == 0
