"""Profiling hooks: the program's spans, and torch.profiler traces.

The port's counterpart of ``realtime_whisper_asr_tpu/utils/profiling.py``,
with spans where that module has a phase timer. The layers mark
their work with ``span(name)``, a context manager: every span records its
name (a fixed ``<layer>.<part>``, never an id), its start and end on
``time.perf_counter()``, a sequence number, its parent (the enclosing span
of the same thread) and ``rid``, the tick it serves (``asr.dispatch``
draws one with ``new_rid()``, its finalize takes the same, and a child
inherits its parent's). Spans wait for nothing: they time the host's work,
and a wait for the card shows as the span around it (``decode.check``,
``asr.fetch_wait``).

Spans go into a bounded in-memory ring, always on; ``spans()`` returns a
snapshot, ``spans_dropped()`` counts what the ring dropped, and
``span_report()`` sums total and self time by name. While ``torch.profiler``
is active each span also opens a ``record_function`` range of its name, and
the ring marks it ``traced``: in the exported Chrome trace the ranges of a
thread bearing the program's span names, in start order, are that thread's
traced ring entries in ``seq`` order, and one offset maps ring times onto the
trace's clock. ``trace(dir)`` writes such a trace of a block.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

#: spans the process keeps; older ones are dropped (``spans_dropped``)
RING_SPANS = 1 << 16

_profiler_enabled = torch._C._autograd._profiler_enabled


def sync_device(device: torch.device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, its trace written into ``log_dir``
    (created if missing) when the block ends. Yields the profiler, whose
    ``key_averages()`` sums time by operation and kernel. The program's
    spans show in it as ``record_function`` ranges of their names."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class Span(NamedTuple):
    """One finished span."""

    seq: int  # in start order, over all threads
    name: str
    t0: float  # start and end, on the recorder's clock (seconds)
    t1: float
    parent: Optional[int]  # seq of the enclosing span on the same thread
    rid: Optional[int]  # the tick it serves
    tid: int  # native thread id: the Chrome trace's ``tid``
    traced: bool  # also a record_function range of the active profiler


_tuple_new = tuple.__new__


class _Open:
    """A span being timed: ``with recorder.span(name) as s`` leaves ``s.t0``
    and ``s.t1`` readable after the block."""

    __slots__ = ("rec", "name", "rid", "seq", "t0", "t1", "_range")

    def __init__(self, rec: "SpanRecorder", name: str, rid: Optional[int]):
        self.rec, self.name, self.rid = rec, name, rid

    def __enter__(self) -> "_Open":
        local = self.rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.tid = threading.get_native_id()
        if self.rid is None and stack:
            self.rid = stack[-1].rid
        self.seq = next(self.rec._seq)
        stack.append(self)
        self._range = None
        # the clock first: the profiler stamps a range as its enter starts,
        # and the first enter under a new profiler can take a millisecond
        self.t0 = self.rec.clock()
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        self.t1 = rec.clock()
        local = rec._local
        stack = local.stack
        stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        ring = rec.ring
        if len(ring) == ring.maxlen:
            rec.dropped += 1
        # tuple.__new__ skips the named tuple's Python-level constructor
        ring.append(_tuple_new(Span, (self.seq, self.name, self.t0, self.t1,
                                      stack[-1].seq if stack else None, self.rid, local.tid,
                                      self._range is not None)))


class SpanRecorder:
    """The spans of a process: a ring of the last ``maxlen`` finished spans
    (``ring``) and the count it dropped (``dropped``; the ring is full once
    it has dropped any)."""

    def __init__(self, maxlen: int = RING_SPANS, clock=time.perf_counter):
        self.clock = clock
        self.ring: collections.deque = collections.deque(maxlen=maxlen)
        self.dropped = 0
        self._seq = itertools.count()
        self._rids = itertools.count()
        self._local = threading.local()

    def span(self, name: str, rid: Optional[int] = None) -> _Open:
        """A context manager timing the block as span ``name``; ``rid``
        None takes the enclosing span's."""
        return _Open(self, name, rid)

    def new_rid(self) -> int:
        """A fresh tick id (``asr.dispatch`` draws one)."""
        return next(self._rids)

    def spans(self) -> list[Span]:
        """A snapshot of the ring, oldest end first."""
        return list(self.ring.copy())

    def report(self, since: Optional[float] = None) -> dict[str, dict[str, float]]:
        """``{name: {"total_s", "self_s", "count", "mean_ms"}}`` over the
        spans in the ring that started at or after ``since`` (all when None);
        a span's self time is its duration less what its children cover."""
        kept = [s for s in self.spans() if since is None or s.t0 >= since]
        own = {s.seq: s.t1 - s.t0 for s in kept}
        for s in kept:
            if s.parent in own:
                own[s.parent] -= s.t1 - s.t0
        out: dict[str, dict[str, float]] = {}
        for s in sorted(kept, key=lambda s: s.seq):
            row = out.setdefault(s.name, {"total_s": 0.0, "self_s": 0.0, "count": 0})
            row["total_s"] += s.t1 - s.t0
            row["self_s"] += own[s.seq]
            row["count"] += 1
        for row in out.values():
            row["mean_ms"] = 1e3 * row["total_s"] / row["count"]
        return out


#: the process's recorder, which the program's layers record into
recorder = SpanRecorder()
span = recorder.span
new_rid = recorder.new_rid
spans = recorder.spans
span_report = recorder.report


def spans_dropped() -> int:
    """Spans the process's ring has dropped."""
    return recorder.dropped
