"""``encode.captures.tput``: the program's ``encode.capture`` spans in the
window outside the traced span, counted on synthetic rings; None for a
program whose backend counts no encode captures or whose ring dropped a
span of the window; 0 in the harness's run at test-tiny (the CPU encodes
eagerly)."""

from __future__ import annotations

import types

import torch

from conftest import REPO, make_root
from portbench.core import harness, readers, spec
from realtime_whisper_asr_tpu_torch.utils import profiling as P

NAME = "encode.captures.tput"
W0, W1, TRACED = 10.0, 20.0, (14.0, 15.0)


def _run(counters=None):
    asr = types.SimpleNamespace(counters={"encode_captures": 0} if counters is None
                                else counters)
    ctx = types.SimpleNamespace(t_w0=W0, t_w1=W1, extra={"trace_span": TRACED},
                                loop0={}, loop1={}, asr=asr)
    return readers.RunData(ctx, {}, None, None, [], {})


def _ring() -> list:
    """Ticks at ``t`` whose encode captured (a capture span inside the
    encode span) or replayed: one capture before the window, two inside it,
    one under the traced span and one replay inside."""
    out, seq = [], [0]

    def tick(rid, t, captured):
        def add(name, a, b, parent):
            seq[0] += 1
            out.append(P.Span(seq[0], name, t + a, t + b, parent, rid, 1, False))
            return seq[0]

        d = add("asr.dispatch", 0.0, 0.1, None)
        e = add("encode", 0.01, 0.05, d)
        if captured:
            add("encode.capture", 0.01, 0.04, e)

    for rid, (t, captured) in enumerate([(7.0, True), (11.0, True), (12.0, False),
                                         (14.5, True), (18.0, True)]):
        tick(rid, t, captured)
    return sorted(out, key=lambda s: s.t1)


def _use_ring(monkeypatch, ring, dropped=0):
    monkeypatch.setattr(P, "spans", lambda: list(ring))
    monkeypatch.setattr(P, "spans_dropped", lambda: dropped)


def test_captures_count_the_windows_capture_spans_outside_the_trace(monkeypatch):
    _use_ring(monkeypatch, _ring())
    assert spec.metric_reader(REPO, NAME)(_run()) == 2.0


def test_a_program_without_encode_graphs_gives_none(monkeypatch):
    _use_ring(monkeypatch, _ring())
    assert spec.metric_reader(REPO, NAME)(_run({"encode_flops": 0})) is None
    no_asr = _run()
    no_asr.ctx.asr = None
    assert spec.metric_reader(REPO, NAME)(no_asr) is None


def test_a_dropped_span_of_the_window_gives_none(monkeypatch):
    _use_ring(monkeypatch, [s for s in _ring() if s.t1 >= W0], dropped=2)
    assert spec.metric_reader(REPO, NAME)(_run()) is None


class _NoTrace:
    prof = None

    def start(self):
        pass

    def stop(self):
        pass


def test_the_kind_at_test_tiny_reads_no_capture(tmp_path, monkeypatch):
    from portbench.core import trace

    monkeypatch.setattr(trace, "Tracer", _NoTrace)
    root, bench = make_root(tmp_path)
    out = harness.run_cell(root, bench, "tiny.cell", 2**31 + 2468, 3.0, True,
                           torch.device("cpu"), 0.0, log=lambda *_: None)
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME] == {"value": 0.0, "unit": "count"}
