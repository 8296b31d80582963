"""The port's spans (``utils/profiling.py``) and the decode loop's graph
counters.

A ``SpanRecorder`` is held against a fake clock (nesting, parents, ``rid``
inheritance, self time) and a small ring (its bound and drop count); a
test-tiny ``TorchWhisperASR`` on the CPU gives the span tree of a window
under one ``rid`` per window, every pipeline mode finalizes each ``rid``
once after its dispatch, no ``record_function`` is made while the profiler
is off, and under a CPU ``torch.profiler`` every marked span is in the
exported Chrome trace, joined by per-thread order with one clock offset.
The graph counters run on a ``DecodeLoop`` whose capture is stubbed (the
CPU cannot capture).
"""

import collections
import json
import os
import statistics
import time

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor
from realtime_whisper_asr_tpu_torch.utils import profiling

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
SR = 16000

#: one window's spans below its asr.dispatch and asr.finalize: name -> count
#: (a test-tiny window with a cap of 8 tokens: 4 loop checks, no capture)
DISPATCH_TREE = {"asr.plan": 1, "asr.upload": 1, "encode": 1, "decode.prefill": 1,
                 "decode.loop": 1, "decode.pack": 2}
FINALIZE_TREE = {"asr.fetch_wait": 1, "asr.parse": 2}


class FakeClock:
    def __init__(self, *times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.fixture(scope="module")
def asr():
    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 8
    return asr


def _audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def _since(t: float) -> list:
    return sorted((s for s in profiling.spans() if s.t0 >= t), key=lambda s: s.seq)


def test_spans_nest_with_parents_rids_and_self_time():
    rec = profiling.SpanRecorder(clock=FakeClock(0.0, 1.0, 1.5, 1.5, 2.0, 4.0, 10.0, 10.5))
    with rec.span("asr.dispatch", rid=7) as outer:
        with rec.span("asr.plan"):
            pass
        with rec.span("encode") as enc:
            pass
    with pytest.raises(KeyError), rec.span("stream.tick"):
        raise KeyError("the span still ends")
    plan, encode, dispatch, tick = rec.spans()  # in order of their ends
    assert (outer.t0, outer.t1, enc.t0, enc.t1) == (0.0, 4.0, 1.5, 2.0)
    assert [s.name for s in (plan, encode, dispatch, tick)] == [
        "asr.plan", "encode", "asr.dispatch", "stream.tick"]
    assert plan.parent == encode.parent == dispatch.seq and dispatch.parent is None
    assert plan.rid == encode.rid == dispatch.rid == 7 and tick.rid is None
    assert dispatch.seq < plan.seq < encode.seq < tick.seq
    assert not any(s.traced for s in rec.spans())
    report = rec.report()
    assert report["asr.dispatch"] == pytest.approx(
        {"total_s": 4.0, "self_s": 4.0 - 0.5 - 0.5, "count": 1, "mean_ms": 4000.0})
    assert report["stream.tick"]["self_s"] == pytest.approx(0.5)
    assert set(rec.report(since=5.0)) == {"stream.tick"}


def test_rids_are_fresh_and_threads_keep_their_own_stacks():
    import threading

    rec = profiling.SpanRecorder()
    assert rec.new_rid() != rec.new_rid()
    seen = {}

    def worker():
        with rec.span("stream.tick"):
            pass
        seen["tid"] = threading.get_native_id()

    with rec.span("asr.dispatch", rid=rec.new_rid()):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    tick = next(s for s in rec.spans() if s.name == "stream.tick")
    # the other thread's span has no parent and no rid from this one's
    assert tick.parent is None and tick.rid is None and tick.tid == seen["tid"]


def test_the_ring_keeps_the_newest_and_counts_what_it_drops():
    rec = profiling.SpanRecorder(maxlen=3)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"]
    assert rec.dropped == 2
    assert rec.ring.maxlen == 3


def test_transcribe_gives_the_span_tree_once_per_window_under_one_rid(asr):
    asr.transcribe(_audio(2.0))  # shapes warm
    t = time.perf_counter()
    asr.transcribe(_audio(40.0))  # two windows of 30 s and 10 s
    spans = _since(t)
    by_rid = collections.defaultdict(list)
    for s in spans:
        by_rid[s.rid].append(s)
    assert len(by_rid) == 2 and None not in by_rid
    for group in by_rid.values():
        (dispatch,) = [s for s in group if s.name == "asr.dispatch"]
        (finalize,) = [s for s in group if s.name == "asr.finalize"]
        assert dispatch.parent is None and finalize.parent is None
        assert finalize.t0 >= dispatch.t1
        children = collections.Counter(s.name for s in group if s.parent == dispatch.seq)
        assert children == DISPATCH_TREE
        assert collections.Counter(s.name for s in group if s.parent == finalize.seq) \
            == FINALIZE_TREE
        (encode,) = [s for s in group if s.name == "encode"]
        assert [s.name for s in group if s.parent == encode.seq] == ["encode.logmel",
                                                                      "encode.model"]
        (loop,) = [s for s in group if s.name == "decode.loop"]
        checks = [s for s in group if s.name == "decode.check"]
        assert checks and all(s.parent == loop.seq for s in checks)
        for s in group:  # every child inside its parent
            parent = next((p for p in group if p.seq == s.parent), None)
            assert parent is None or parent.t0 <= s.t0 <= s.t1 <= parent.t1
    report = profiling.span_report(since=t)
    assert report["asr.dispatch"]["count"] == 2
    assert report["decode.check"]["count"] == len([s for s in spans if s.name == "decode.check"])


@pytest.mark.parametrize("pipeline", [False, True, "async"], ids=["sync", "exact", "async"])
def test_each_rid_is_finalized_once_after_its_dispatch(asr, pipeline):
    proc = OnlineASRProcessor(asr, pipeline=pipeline)
    audio = _audio(5.0, seed=1)
    t = time.perf_counter()
    for pos in range(0, len(audio), SR):
        proc.insert_audio_chunk(audio[pos : pos + SR])
        proc.process_iter()
    proc.finish()
    spans = _since(t)
    ticks = [s for s in spans if s.name == "stream.tick"]
    assert len(ticks) == 5
    dispatches = {s.rid: s for s in spans if s.name == "asr.dispatch"}
    finalizes = collections.defaultdict(list)
    for s in spans:
        if s.name == "asr.finalize":
            finalizes[s.rid].append(s)
    assert len(dispatches) == 5 and set(finalizes) == set(dispatches)

    def tick_of(s):
        return next((i for i, k in enumerate(ticks) if k.t0 <= s.t0 <= k.t1), None)

    for rid, d in dispatches.items():
        (f,) = finalizes[rid]
        assert f.t0 >= d.t1
        # a pipelined tick is collected one process_iter later (the last by finish)
        lag = 0 if not pipeline else 1
        assert tick_of(f) == (None if tick_of(d) + lag == len(ticks) else tick_of(d) + lag)
    by_seq = {s.seq: s for s in spans}
    for name in ("stream.prepare", "stream.apply"):
        assert len([s for s in spans if s.name == name]) == 5
    for s in spans:
        if s.name == "stream.prepare":
            assert by_seq[s.parent].name == "stream.tick"


def test_no_record_function_is_made_while_the_profiler_is_off(asr, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t = time.perf_counter()
    asr.transcribe(_audio(2.0))
    spans = _since(t)
    assert spans and not any(s.traced for s in spans)


def test_profiled_spans_join_the_chrome_trace(asr, tmp_path):
    asr.transcribe(_audio(2.0))
    t = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        asr.transcribe(_audio(2.0))
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    spans = _since(t)
    assert spans and all(s.traced for s in spans)
    names = {s.name for s in spans}
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") in names]
    ranges, ring = collections.defaultdict(list), collections.defaultdict(list)
    for e in sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        ranges[e["tid"]].append(e)
    for s in spans:
        ring[s.tid].append(s)
    assert set(ranges) == set(ring)
    pairs = []
    for tid, ss in ring.items():
        assert [e["name"] for e in ranges[tid]] == [s.name for s in ss]
        pairs += zip(ranges[tid], ss)
    offsets = [float(e["ts"]) - 1e6 * s.t0 for e, s in pairs]
    offset = statistics.median(offsets)
    assert max(abs(o - offset) for o in offsets) < 1000.0  # µs
    ends = [float(e["ts"]) + float(e["dur"]) - 1e6 * s.t1 - offset for e, s in pairs]
    assert max(abs(x) for x in ends) < 1000.0


class _Key:
    """A loop shape: ``DecodeLoop`` only hashes and compares it."""

    def __init__(self, n):
        self.n = n

    def __hash__(self):
        return self.n

    def __eq__(self, other):
        return self.n == other.n


def test_the_loop_counts_evictions_and_recaptures(monkeypatch):
    loop = D.DecodeLoop()
    built = []

    def capture(model, key, dtype, device, sup_mask, amask):
        built.append(key.n)
        loop.stats["captures"] += 1
        return D._Loop(None, lambda: None, ())

    monkeypatch.setattr(loop, "_capture", capture)

    def ask(n):
        return loop.loop(None, _Key(n), None, None, None, None, captured=True)

    for n in range(D.MAX_GRAPHS + 1):  # the first shape goes past MAX_GRAPHS
        ask(n)
    assert loop.stats["evictions"] == 1 and loop.stats["recaptures"] == 0
    ask(D.MAX_GRAPHS)  # kept: no capture
    ask(0)  # evicted before: captured again, and shape 1 goes
    assert built == list(range(D.MAX_GRAPHS + 1)) + [0]
    assert loop.stats["evictions"] == 2 and loop.stats["recaptures"] == 1
    ask(D.MAX_GRAPHS + 5)  # new: a capture, not a recapture
    assert loop.stats["recaptures"] == 1 and loop.stats["captures"] == D.MAX_GRAPHS + 3
