"""The multi-stream server over both packages, on fake backends (CPU).

``tests/test_serving.py``'s cases, each run against the JAX package's
``StreamServer`` and the port's (``realtime_whisper_asr_tpu_torch.serving``),
with its fakes (``PerStreamFakeASR`` and the batching and pipelined ones)
and ``tests/test_streaming.py``'s: isolation, round-robin, shedding and
recovery, close and flush, the staged pending utterance, batching and
language groups, the pipelined overlap, no double tick, concurrent churn,
group failures, the TCP transport over a real socket, and the memory-safe
batch with the same numbers (beam states too). A host separator runs on
every fed chunk and ``diarize=True`` gives every VAC stream a speaker
tracker in both servers (``tests/test_torch_speaker.py`` holds the labels
equal); a ``beam_size`` of 2 is served as the JAX server serves it. The
port's memory cap counts the fused separation frontend's transient.
"""

import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import realtime_whisper_asr_tpu.serving as JS
import realtime_whisper_asr_tpu.serving_tcp as JT
import realtime_whisper_asr_tpu_torch.serving as PS
import realtime_whisper_asr_tpu_torch.serving_tcp as PT
from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from tests.test_serving import (
    BatchingFakeASR,
    FlakyDispatchASR,
    PerStreamFakeASR,
    PipelinedFakeASR,
    _RecordingSeparator,
)
from tests.test_streaming import ScriptedProbs, make_words, timecoded_audio

PACKAGES = {"jax": (JS, JT), "torch": (PS, PT)}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    serving, tcp = PACKAGES[request.param]
    return types.SimpleNamespace(name=request.param, StreamServer=serving.StreamServer,
                                 serving=serving, tcp=tcp)


def _feed_steps(server, sids, spans, outs=None):
    for t0, t1 in spans:
        for sid in sids:
            server.feed(sid, timecoded_audio(t0, t1))
        while server.step():
            pass
        if outs is not None:
            for sid in sids:
                outs[sid].extend(server.poll(sid))


def _run_two_streams(pkg, asr, **kw):
    server = pkg.StreamServer(asr, use_vad=False, online_chunk_size=0.5, **kw)
    a, b = server.create_stream(), server.create_stream()
    outs = {a: [], b: []}
    _feed_steps(server, (a, b), [(t, t + 1.0) for t in (0.0, 1.0, 2.0, 3.0)], outs)
    outs[a].extend(server.close_stream(a))
    outs[b].extend(server.close_stream(b))
    return ["".join(r.text for r in outs[sid]) for sid in (a, b)]


WORDS_A = [(0.5, 0.9, " alpha1"), (1.2, 1.6, " alpha2"), (2.2, 2.6, " alpha3")]
WORDS_B = [(0.5, 0.9, " beta1"), (1.2, 1.6, " beta2"), (2.2, 2.6, " beta3")]


def test_two_streams_isolated_outputs(pkg):
    words_a = [(0.5, 0.9, " alpha1"), (1.0, 1.4, " alpha2"), (2.0, 2.4, " alpha3")]
    words_b = [(0.5, 0.9, " beta1"), (1.2, 1.6, " beta2"), (2.1, 2.5, " beta3")]
    server = pkg.StreamServer(PerStreamFakeASR({1: words_a, 2: words_b}), use_vad=False,
                              online_chunk_size=0.5)
    a, b = server.create_stream(), server.create_stream()
    outs = {a: [], b: []}
    _feed_steps(server, (a, b), [(t, t + 1.0) for t in range(5)], outs)
    outs[a].extend(server.close_stream(a))
    outs[b].extend(server.close_stream(b))
    text_a, text_b = ("".join(r.text for r in outs[s]) for s in (a, b))
    assert "alpha1" in text_a and "alpha3" in text_a
    assert "beta1" in text_b and "beta3" in text_b
    assert "beta" not in text_a and "alpha" not in text_b
    st = server.get_stats()
    assert st["total_streams"] == 0 and st["streams"] == 0


def test_round_robin_fairness(pkg):
    server = pkg.StreamServer(PerStreamFakeASR({i: make_words(8) for i in (1, 2, 3)}),
                              use_vad=False, online_chunk_size=0.5)
    sids = [server.create_stream() for _ in range(3)]
    _feed_steps(server, sids, [(float(t), float(t + 1)) for t in range(6)])
    stats = server.get_stats()["per_stream"]
    ticks = [stats[sid]["ticks"] for sid in sids]
    assert max(ticks) - min(ticks) <= 1, f"unfair: {ticks}"


def test_load_shedding_kicks_in(pkg):
    server = pkg.StreamServer(PerStreamFakeASR({1: make_words(10)}), use_vad=False,
                              online_chunk_size=0.5)
    sid = server.create_stream()
    for _ in range(20):
        server.monitor.record_recognition(audio_seconds=1.0, processing_seconds=5.0)
    server.feed(sid, timecoded_audio(0.0, 2.0))
    assert server.step() is True
    assert server.streams[sid].skipped_ticks == 1


def test_closed_stream_rejects_feed(pkg):
    server = pkg.StreamServer(PerStreamFakeASR({1: []}), use_vad=False)
    sid = server.create_stream()
    server.close_stream(sid)
    with pytest.raises(ValueError):
        server.feed(sid, np.zeros(100, np.float32))


def test_close_stream_transcribes_remaining_audio(pkg):
    server = pkg.StreamServer(PerStreamFakeASR({1: [(0.4, 0.8, " lastword")]}), use_vad=False)
    sid = server.create_stream()
    server.feed(sid, timecoded_audio(0.0, 2.0))
    assert any("lastword" in r.text for r in server.close_stream(sid))


def test_shed_then_starve_recovers(pkg):
    server = pkg.StreamServer(PerStreamFakeASR({1: [(0.4, 0.8, " probe")]}), use_vad=False,
                              max_consecutive_sheds=2)
    sid = server.create_stream()
    for _ in range(20):
        server.monitor.record_recognition(1.0, 5.0)
    server.feed(sid, timecoded_audio(0.0, 2.0))
    for _ in range(6):
        server.step()
    s = server.streams[sid]
    assert s.ticks >= 1, "probe-through never ran a real tick"
    assert s.audio_since_tick == 0.0


def _churn(server, feeds):
    errors = []

    def churn():
        try:
            for _ in range(12):
                sid = server.create_stream()
                for t0 in range(feeds):
                    server.feed(sid, timecoded_audio(float(t0), float(t0 + 1)))
                server.close_stream(sid)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    server.start()
    threads = [threading.Thread(target=churn) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    server.stop()
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert server.get_stats()["total_streams"] == 0


def test_concurrent_feed_and_close_no_crash(pkg):
    _churn(pkg.StreamServer(PerStreamFakeASR({i: make_words(4) for i in range(1, 40)}),
                            use_vad=False), feeds=1)


def test_concurrent_churn_pipelined_backend(pkg):
    asr = PipelinedFakeASR({i: make_words(4) for i in range(1, 60)})
    _churn(pkg.StreamServer(asr, use_vad=False), feeds=2)
    n_d = sum(1 for e in asr.events if e[0] == "dispatch")
    assert n_d == sum(1 for e in asr.events if e[0] == "finalize")


def test_tcp_server_end_to_end(pkg):
    """PCM in over a real socket, 'beg_ms end_ms text' lines out."""
    words = {1: [(0.5, 0.9, " hello"), (1.2, 1.6, " network")]}
    stream_server = pkg.StreamServer(PerStreamFakeASR(words), use_vad=False,
                                     online_chunk_size=0.5)
    srv = pkg.tcp.TCPTranscriptionServer(("127.0.0.1", 0), stream_server)
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    try:
        sock = socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=5)
        pcm = (np.clip(timecoded_audio(0.0, 3.0), -1, 1) * 32768).astype(np.int16)
        sock.sendall(pcm.tobytes())
        time.sleep(0.5)
        sock.shutdown(socket.SHUT_WR)
        sock.settimeout(5)
        data = b""
        try:
            while True:
                part = sock.recv(4096)
                if not part:
                    break
                data += part
        except socket.timeout:
            pass
        text = data.decode("utf-8")
        assert "hello" in text and "network" in text, text
        for line in text.strip().splitlines():
            beg, end, *_ = line.split(" ", 2)
            assert int(beg) <= int(end)
    finally:
        srv.shutdown()
        t.join(timeout=5)
    assert not t.is_alive()


def test_tcp_emit_prefixes_speaker_label(pkg):
    sent = []

    class Sock:
        def sendall(self, b):
            sent.append(bytes(b))

    pkg.tcp._Handler._emit(Sock(), [pkg.serving.StreamResult(1, 0.5, 1.25, " hello", speaker="S3"),
                                    pkg.serving.StreamResult(1, 1.25, 2.0, " there")])
    assert b"".join(sent).decode("utf-8").strip().splitlines() == [
        "500 1250 [S3] hello", "1250 2000 there"]


def test_default_language_restored_for_unspecified_streams(pkg):
    asr = PerStreamFakeASR({1: make_words(3), 2: make_words(3)})
    asr.original_language = "en"
    server = pkg.StreamServer(asr, use_vad=False, online_chunk_size=0.5)
    a = server.create_stream(language="zh")
    b = server.create_stream()
    seen = {}
    orig = asr.transcribe

    def spy(audio, init_prompt="", **kw):
        seen[asr.active] = asr.original_language
        return orig(audio, init_prompt, **kw)

    asr.transcribe = spy
    _feed_steps(server, (a, b), [(t, t + 1.0) for t in (0.0, 1.0, 2.0)])
    assert seen[a] == "zh" and seen[b] == "en"


def test_batched_step_groups_same_language_streams(pkg):
    asr = BatchingFakeASR({1: WORDS_A, 2: WORDS_B})
    text_a, text_b = _run_two_streams(pkg, asr)
    assert any(n >= 2 for n in asr.batch_sizes), asr.batch_sizes
    assert "alpha1" in text_a and "alpha3" in text_a and "beta" not in text_a
    assert "beta1" in text_b and "beta3" in text_b and "alpha" not in text_b


@pytest.mark.parametrize("fake", [BatchingFakeASR, PipelinedFakeASR],
                         ids=["batched", "pipelined"])
def test_outputs_match_sequential_serving(pkg, fake):
    assert (_run_two_streams(pkg, fake({1: WORDS_A, 2: WORDS_B}))
            == _run_two_streams(pkg, PerStreamFakeASR({1: WORDS_A, 2: WORDS_B})))


def _two_languages(pkg, asr):
    server = pkg.StreamServer(asr, use_vad=False, online_chunk_size=0.5)
    a, b = server.create_stream(language="en"), server.create_stream(language="zh")
    _feed_steps(server, (a, b), [(t, t + 1.0) for t in (0.0, 1.0, 2.0, 3.0)])
    return server, a, b


def test_batching_respects_language_groups(pkg):
    asr = BatchingFakeASR({1: make_words(3), 2: make_words(3)})
    _two_languages(pkg, asr)
    assert all(n == 1 for n in asr.batch_sizes), asr.batch_sizes


def test_pipelined_dispatch_overlaps_finalize(pkg):
    asr = PipelinedFakeASR({1: make_words(6), 2: make_words(6)})
    server, a, b = _two_languages(pkg, asr)
    open_groups, overlapped = 0, False
    for ev, _ in asr.events:
        open_groups += 1 if ev == "dispatch" else -1
        overlapped |= open_groups >= 2
    assert overlapped, asr.events
    server.close_stream(a)
    server.close_stream(b)
    assert (sum(1 for e in asr.events if e[0] == "dispatch")
            == sum(1 for e in asr.events if e[0] == "finalize"))


def test_pipelined_no_double_tick_while_inflight(pkg):
    asr = PipelinedFakeASR({1: make_words(6)})
    server = pkg.StreamServer(asr, use_vad=False, online_chunk_size=0.5)
    a = server.create_stream()
    server.feed(a, timecoded_audio(0.0, 1.0))
    server.step()
    server.feed(a, timecoded_audio(1.0, 2.0))
    server.step()
    for (ev1, k1), (ev2, k2) in zip(asr.events, asr.events[1:]):
        if ev1 == "dispatch" and k1 == (1,):
            assert not (ev2 == "dispatch" and k2 == (1,))
    assert ("dispatch", (1,)) in asr.events
    server.close_stream(a)


def test_group_failures_counted_and_service_recovers(pkg):
    words = [(0.5, 0.9, " alpha1"), (1.2, 1.6, " alpha2"), (2.2, 2.6, " alpha3")]
    asr = FlakyDispatchASR({1: words, 2: words}, fail_first=2)
    server = pkg.StreamServer(asr, use_vad=False, online_chunk_size=0.5)
    a, b = server.create_stream(), server.create_stream()
    outs = {a: [], b: []}
    _feed_steps(server, (a, b), [(t, t + 1.0) for t in (0.0, 1.0, 2.0, 3.0)], outs)
    text = "".join(r.text for sid in (a, b) for r in outs[sid] + server.close_stream(sid))
    assert "alpha" in text
    assert asr.dispatch_calls > 2
    assert server.get_stats()["group_failures"] == 2


def test_close_stream_flushes_staged_pending_utterance(pkg):
    server = pkg.StreamServer(
        PerStreamFakeASR({1: [(0.5, 0.9, " first"), (2.7, 3.1, " second")]}),
        use_vad=True, vad_factory=lambda: ScriptedProbs([(0.2, 1.2), (2.5, 3.6)]),
        min_silence_duration_ms=500, online_chunk_size=0.5)
    sid = server.create_stream()
    for t in range(4):
        server.feed(sid, timecoded_audio(float(t), float(t) + 1.0))
    server.feed(sid, timecoded_audio(4.0, 4.5))
    text = "".join(r.text for r in server.close_stream(sid))
    assert "first" in text and "second" in text, text


def test_diarize_and_separation(pkg):
    """Both servers run a host separator on every fed chunk and give each
    VAC stream of a ``diarize=True`` server its own speaker tracker over one
    shared embedder; both serve a backend whose ``beam_size`` is 2 alike."""
    words = [(0.5, 0.9, " one"), (1.0, 1.4, " two"), (2.0, 2.4, " three")]
    sep = _RecordingSeparator()
    server = pkg.StreamServer(PerStreamFakeASR({1: words}), use_vad=False,
                              online_chunk_size=0.5, separator=sep)
    sid = server.create_stream()
    _feed_steps(server, [sid], [(t, t + 1.0) for t in range(4)])
    assert server.get_stats()["separator"]["processed"] == 4
    server.close_stream(sid)
    assert sep.stats["processed"] == 4 and not server.fused_separation
    server = pkg.StreamServer(PerStreamFakeASR({1: words, 2: words}), use_vad=True,
                              vad_factory=lambda: ScriptedProbs([(0.0, 30.0)]), diarize=True)
    a, b = server.create_stream(), server.create_stream()
    trackers = [server.streams[sid].diarizer.tracker for sid in (a, b)]
    assert trackers[0] is not trackers[1]
    assert trackers[0].embedder is trackers[1].embedder
    for sid in (a, b):
        server.close_stream(sid)
    if pkg.name == "torch":
        texts = []
        for serving, _ in PACKAGES.values():
            asr = PerStreamFakeASR({1: words})
            asr.transcribe_kargs = {"beam_size": 2}
            server = serving.StreamServer(asr, use_vad=False, online_chunk_size=0.5)
            sid = server.create_stream()
            outs = {sid: []}
            _feed_steps(server, [sid], [(t, t + 1.0) for t in range(4)], outs)
            texts.append("".join(r.text for r in outs[sid] + server.close_stream(sid)))
        assert texts[0] == texts[1] and "one" in texts[1] and "three" in texts[1], texts


def test_row_bytes_count_the_fused_separation():
    """With the fused frontend a row also holds its separation's transient
    at the 30 s bucket: the widest conv's input and output planes beside the
    spectrum, 1,876 frames x 513 bins each (123 MB a 32-channel layer)."""
    from realtime_whisper_asr_tpu_torch.models import separation_nn as SEP

    cfg = get_config("large-v3")
    params = SEP.params_from_jax(dict(np.load(SEP.VARIANT_WEIGHTS["default"])), "cpu")
    frames = 1 + cfg.n_audio_ctx * 2 * 160 // SEP.HOP
    assert frames == 1876
    widest = 24 + 32  # enc2: 24 channels in, 32 out
    assert SEP.separation_bytes(params, 480000) == frames * 513 * 4 * (widest + 4)
    assert (PS._row_bytes(cfg, separation=params) - PS._row_bytes(cfg)
            == SEP.separation_bytes(params, 480000))
    assert (PS._hbm_safe_batch(cfg, 2 * 10**9, 80 * 2**30, separation=params)
            <= PS._hbm_safe_batch(cfg, 2 * 10**9, 80 * 2**30))


@pytest.mark.parametrize("name", ["large-v3", "tiny"])
def test_hbm_safe_batch_same_numbers(pkg, name):
    """The memory-safe dispatch batch. JAX: the formula calibrated on a 16 GB
    v5e (large-v3 int8-all serves 2 x 16 rows, fails at 2 x 17). Port: the
    same budget and two groups in flight over the row cost the port
    allocates (``_row_bytes``, locked by
    ``test_row_bytes_equals_allocated_loop_state``), so its numbers are its
    own: large-v3 int8-all on an 80 GiB card takes 11 rows a group, 18 at
    int8-kv."""
    cfg = (W.get_config if pkg.name == "jax" else get_config)(name)
    f = pkg.serving._hbm_safe_batch
    if pkg.name == "jax" and name == "large-v3":
        cap = f(cfg, 1_600_000_000, 16 * 2**30)
        assert cap is not None and 16 <= cap < 32, cap
        assert f(cfg, 15 * 2**30, 16 * 2**30) == 1
    elif pkg.name == "jax":
        assert f(cfg, 80_000_000, 16 * 2**30) > 64
    elif name == "large-v3":
        int8all = int(1.74 * 2**30)  # large-v3 int8-all's parameters and buffers on the card
        assert f(cfg, int8all, 80 * 2**30) == 11
        assert f(cfg, int8all, 80 * 2**30, kv_quant=True) == 18
        assert f(cfg, 15 * 2**30, 16 * 2**30) == 1
    else:
        assert f(cfg, 80_000_000, 16 * 2**30) > 8  # above the server's default max_batch
    assert f(cfg, 1_600_000_000, None) is None
    assert f(None, 0, 16 * 2**30) is None


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8-kv"])
def test_row_bytes_equals_allocated_loop_state(kv_quant):
    """The port's row cost against what its decode loop allocates:
    ``MAX_GRAPHS`` times the state bytes one row adds at the largest loop
    shape (30 s bucket, the whole self cache, the 224-step bound with word
    capture), plus the encoder's score transient; and the int8-kv cap above
    the bf16 one, as tests/test_serving.py asserts of the JAX package. The
    same for a beam search of 5 beams (``beam.new_state``: 5 self caches
    and capture buffers, 5 token rows and the (5, 5, n_text_ctx) ancestry
    table a stream, the cross K/V once), whose cap at large-v3 bf16 is
    about half the greedy one."""
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper

    cfg = get_config("test-tiny")
    model = Whisper.empty(cfg, torch.bfloat16, "cpu", "int8-kv" if kv_quant else None)
    scores = cfg.n_audio_head * cfg.n_audio_ctx**2 * (4 + 4 + 2)
    for beam_size in (1, 5):
        opts = D.DecodeOptions(word_timestamps=True, max_new_tokens=10**6, beam_size=beam_size)
        max_new, _ = D.plan_decode_budget(cfg, opts, 8, 0)
        assert max_new == 224  # the largest loop bound
        p = cfg.n_text_ctx - max_new

        def state_bytes(batch: int) -> int:
            key = D.LoopKey(id(model), cfg.n_audio_ctx, p, max_new, cfg.n_text_ctx, 0, batch,
                            opts, (), None)
            return D._state_bytes(D._loop_parts(model, key, torch.bfloat16, "cpu", None,
                                                None)[0])

        row = state_bytes(2) - state_bytes(1)
        assert state_bytes(1) == row + (16 if beam_size == 1 else 8)  # the shared scalars
        assert PS._row_bytes(cfg, kv_quant, 2, beam_size) == D.MAX_GRAPHS * row + scores
    big = get_config("large-v3")
    assert (PS._hbm_safe_batch(big, 2 * 10**9, 80 * 2**30, kv_quant=True)
            > PS._hbm_safe_batch(big, 2 * 10**9, 80 * 2**30))
    big_scores = big.n_audio_head * big.n_audio_ctx**2 * (4 + 4 + 2)
    greedy, beam = ((PS._row_bytes(big, False, 2, k) - big_scores) // D.MAX_GRAPHS
                    for k in (1, 5))
    assert 318e6 < greedy < 322e6 and 612e6 < beam < 622e6, (greedy, beam)
    caps = [PS._hbm_safe_batch(big, 2 * 10**9, 80 * 2**30, beam_size=k) for k in (1, 5)]
    assert caps[1] < caps[0] * 0.6, caps


def test_server_clamps_oversized_max_batch(pkg, monkeypatch):
    """A max_batch above the memory-safe batch is clamped at construction.
    JAX: the params tree's bytes and a pinned 16 GB HBM probe. Port: the
    model's parameter and buffer bytes (a meta-device buffer, nothing
    allocated) and an 80 GiB card."""
    asr = PerStreamFakeASR({1: [(0.5, 0.9, " one")]})
    if pkg.name == "jax":
        import jax.numpy as jnp

        from realtime_whisper_asr_tpu.utils import hardware

        monkeypatch.setattr(hardware, "detect_hardware", lambda: {"hbm_bytes": 16 * 2**30})
        asr.cfg = W.get_config("large-v3")
        asr.params = {"w": jnp.zeros(1_600_000_000 // 4, jnp.float32)}
        low = 16
    else:
        asr.cfg, asr.device = get_config("large-v3"), torch.device("cuda")
        asr.model = torch.nn.Module()
        asr.model.register_buffer("q", torch.empty(1_200_000_000, dtype=torch.int8,
                                                   device="meta"))
        asr.model.w = torch.nn.Parameter(torch.empty(100_000_000, device="meta"))
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda d: types.SimpleNamespace(total_memory=80 * 2**30))
        low = 8
    server = pkg.StreamServer(asr, use_vad=False, max_batch=32)
    assert server.get_stats()["device_batch_cap"] == server.max_batch
    assert low <= server.max_batch < 32
    assert pkg.StreamServer(asr, use_vad=False, max_batch=4).max_batch == 4
