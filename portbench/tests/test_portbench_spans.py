"""The readings of the program's spans (``core/spans.py`` and the seven
metrics that read it) on synthetic rings: the window and the traced span
filtered out, spans grouped by tick (``rid``), None where the ring dropped
a span of the window or the program keeps none; and the harness's run at
test-tiny reading all seven from the program's own ring."""

from __future__ import annotations

import types

import pytest
import torch

from conftest import REPO, make_root
from portbench.core import harness, readers, spec
from portbench.core import spans as S
from realtime_whisper_asr_tpu_torch.utils import profiling as P

#: the seven metrics that read the program's spans and counters
METRICS = ("asr.upload_host_ms.tput", "encode.host_ms.tput", "decode.prefill_host_ms.tput",
           "decode.check_wait_ms.tput", "decode.recaptures.tput", "asr.fetch_wait_ms.tput",
           "streaming.hold_ms.tput")
W0, W1, TRACED = 10.0, 20.0, (14.0, 15.0)


def _run(loop0=None, loop1=None):
    ctx = types.SimpleNamespace(t_w0=W0, t_w1=W1, extra={"trace_span": TRACED},
                                loop0=loop0 or {}, loop1=loop1 or {})
    return readers.RunData(ctx, {}, None, None, [], {})


def _tick(rid: int, t: float, k: float, seq: list) -> list:
    """One tick's spans from ``t``, every duration ``k`` times the base:
    plan 10 ms, upload 10, encode 30, prefill 20, two checks of 5, the
    finalize 200 ms after the dispatch's end with a 4 ms wait."""
    out = []

    def add(name, a, b, parent=None):
        seq[0] += 1
        out.append(P.Span(seq[0], name, a, b, parent, rid, 1, False))
        return seq[0]

    d = add("asr.dispatch", t, t + 0.1 * k)
    for name, a, b in (("asr.plan", 0.0, 0.01), ("asr.upload", 0.01, 0.02),
                       ("encode", 0.02, 0.05), ("decode.prefill", 0.05, 0.07),
                       ("decode.check", 0.07, 0.075), ("decode.check", 0.08, 0.085)):
        add(name, t + a * k, t + b * k, d)
    f0 = t + 0.1 * k + 0.2 * k
    f = add("asr.finalize", f0, f0 + 0.02 * k)
    add("asr.fetch_wait", f0, f0 + 0.004 * k, f)
    return out


def _ring() -> list:
    """Ticks before the window, inside it, inside the traced span and at
    its end; only the two inside count, and only they read the base."""
    seq = [0]
    spans = (_tick(1, 7.0, 9.0, seq) + _tick(2, 11.0, 1.0, seq) + _tick(3, 12.0, 1.0, seq)
             + _tick(4, 14.2, 2.0, seq) + _tick(5, 19.75, 1.0, seq))
    spans.append(P.Span(seq[0] + 1, "stream.tick", 11.0, 11.5, None, None, 1, False))
    return sorted(spans, key=lambda s: s.t1)


def _use_ring(monkeypatch, ring, dropped=0):
    monkeypatch.setattr(P, "spans", lambda: list(ring))
    monkeypatch.setattr(P, "spans_dropped", lambda: dropped)


@pytest.mark.parametrize("name,want", [
    ("asr.upload_host_ms.tput", 20.0), ("encode.host_ms.tput", 30.0),
    ("decode.prefill_host_ms.tput", 20.0), ("decode.check_wait_ms.tput", 10.0),
    ("asr.fetch_wait_ms.tput", 4.0), ("streaming.hold_ms.tput", 200.0)])
def test_span_metrics_read_the_window_outside_the_trace_by_tick(monkeypatch, name, want):
    _use_ring(monkeypatch, _ring())
    groups = S.window_spans(_run())
    # tick 1 before the window, tick 4 under the trace; tick 5's finalize past the end
    assert sorted(groups) == [2, 3, 5]
    assert [s.name for s in groups[5]] == ["asr.plan", "asr.upload", "encode",
                                          "decode.prefill", "decode.check", "decode.check",
                                          "asr.dispatch"]
    assert spec.metric_reader(REPO, name)(_run()) == pytest.approx(want)


def test_recaptures_read_the_loop_counter_over_the_window():
    read = spec.metric_reader(REPO, "decode.recaptures.tput")
    assert read(_run({"recaptures": 2, "captures": 9}, {"recaptures": 5, "captures": 12})) == 3.0
    # a program whose loop keeps no such counter
    assert read(_run({"captures": 9}, {"captures": 12})) is None


def test_a_dropped_span_of_the_window_gives_none(monkeypatch):
    ring = _ring()
    inside = [s for s in ring if s.t1 >= W0]
    _use_ring(monkeypatch, inside, dropped=3)
    assert S.window_spans(_run()) is None
    for name in METRICS[:4] + METRICS[5:]:
        assert spec.metric_reader(REPO, name)(_run()) is None
    # the ring dropped spans, but kept one that ended before the window
    _use_ring(monkeypatch, ring, dropped=3)
    assert spec.metric_reader(REPO, "encode.host_ms.tput")(_run()) == pytest.approx(30.0)


def test_a_program_without_spans_gives_none(monkeypatch):
    monkeypatch.delattr(P, "spans")
    assert S.window_spans(_run()) is None
    assert spec.metric_reader(REPO, "streaming.hold_ms.tput")(_run()) is None


class _NoTrace:
    """A tracer that records nothing: the CPU has no device trace, and the
    readers of the program's spans need none."""

    prof = None

    def start(self):
        pass

    def stop(self):
        pass


def test_the_kind_at_test_tiny_reads_all_seven(tmp_path, monkeypatch):
    from portbench.core import trace

    monkeypatch.setattr(trace, "Tracer", _NoTrace)
    root, bench = make_root(tmp_path)
    out = harness.run_cell(root, bench, "tiny.cell", 2**31 + 1357, 3.0, True,
                           torch.device("cpu"), 0.0, log=lambda *_: None)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(METRICS) <= set(got), sorted(got)
    for name in METRICS:
        assert got[name]["value"] >= 0.0, name
    assert got["decode.recaptures.tput"]["value"] == 0.0  # the CPU captures nothing
    assert got["encode.host_ms.tput"]["value"] > 0.0
    assert got["streaming.hold_ms.tput"]["value"] > 0.0
