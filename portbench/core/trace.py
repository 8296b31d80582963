"""The device trace of a traced run: ``torch.profiler`` over a short steady
sub-window, read back from its Chrome trace.

Each kernel (or copy) is charged to the benchmark range its launch sat in:
the runtime call that launched it (``cudaLaunchKernel``, or the
``cudaGraphLaunch`` of a replayed CUDA graph, whose kernels carry that
call's correlation id) ran on a host thread inside a
``portbench.dispatch.<id>`` range, and inside ``portbench.encode.<id>`` for
the encode. The file is written under ``TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "portbench.trace_window"
#: a dispatch whose range ends closer than this to the trace's end may have
#: kernels past it, and is left out of the per-dispatch readings
TAIL_S = 0.2


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    #: dispatch id -> {kernel name: device seconds}, and the same inside its encode
    kernels: dict
    encode: dict
    complete: set  # dispatch ids wholly inside the trace
    device_ops: list  # [[name, seconds]] most time first
    idle_gaps: list  # [[host activity, seconds]] most idle first

    def dispatch_seconds(self, did: int, names=None) -> float:
        k = self.kernels.get(did, {})
        return sum(s for n, s in k.items() if names is None or names(n))

    def encode_seconds(self, did: int, names=None) -> float:
        k = self.encode.get(did, {})
        return sum(s for n, s in k.items() if names is None or names(n))


class Tracer:
    """Starts and stops the profiler; ``read()`` parses what it recorded."""

    def __init__(self):
        import torch

        self._torch = torch
        self.prof = None
        self._range = None

    def start(self) -> None:
        torch = self._torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()

    def stop(self) -> None:
        self._range.__exit__(None, None, None)
        self._torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> TraceData:
        fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return parse(events)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse(events: list) -> TraceData:
    """The readings of a Chrome trace's events (times in microseconds)."""
    launch = {}  # correlation -> (host ts, tid)
    ranges = collections.defaultdict(list)  # (kind, tid) -> [(ts, end, id)]
    cpu = []  # (ts, end, name) of host ops and ranges, for the idle gaps
    device = []
    win = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat.startswith("cuda_"):  # runtime and library launch calls
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (ts, e.get("tid"))
        elif cat == "user_annotation":
            if name == WINDOW_RANGE:
                win = (ts, ts + dur)
                continue
            for kind in ("dispatch", "encode"):
                tag = f"portbench.{kind}."
                if name.startswith(tag):
                    ranges[(kind, e.get("tid"))].append((ts, ts + dur, int(name[len(tag):])))
            cpu.append((ts, ts + dur, name))
        elif cat == "cpu_op":
            cpu.append((ts, ts + dur, name))
    if win is None:
        raise ValueError("the trace holds no window range")
    w0, w1 = win
    for v in ranges.values():
        v.sort()
    starts = {k: [r[0] for r in v] for k, v in ranges.items()}

    def owner(kind, ts, tid):
        v = ranges.get((kind, tid))
        if not v:
            return None
        i = bisect.bisect_right(starts[(kind, tid)], ts) - 1
        if i >= 0 and v[i][0] <= ts <= v[i][1]:
            return v[i][2]
        return None

    kernels = collections.defaultdict(lambda: collections.defaultdict(float))
    encode = collections.defaultdict(lambda: collections.defaultdict(float))
    by_name = collections.defaultdict(float)
    spans = []
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        spans.append((a, b))
        name = e.get("name", "")
        by_name[name] += (b - a) * 1e-6
        src = launch.get((e.get("args") or {}).get("correlation"))
        if src is None:
            continue
        did = owner("dispatch", src[0], src[1])
        if did is not None:
            kernels[did][name] += dur * 1e-6
            if owner("encode", src[0], src[1]) == did:
                encode[did][name] += dur * 1e-6
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    complete = {r[2] for (kind, _), v in ranges.items() if kind == "dispatch" for r in v
                if r[0] >= w0 and r[1] <= w1 - TAIL_S * 1e6}
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        kernels={k: dict(v) for k, v in kernels.items()},
        encode={k: dict(v) for k, v in encode.items()}, complete=complete,
        device_ops=[[n[:160], s] for n, s in ops],
        idle_gaps=_idle_gaps(busy, w0, w1, cpu))


def _label(name: str) -> str:
    for kind in ("dispatch", "encode"):
        if name.startswith(f"portbench.{kind}."):
            return f"portbench.{kind}"
    return name


def _idle_gaps(busy: list, w0: float, w1: float, cpu: list) -> list:
    """Idle time of the device in the window, summed by what the host was
    doing at each gap's middle: the innermost host op or benchmark range
    open then (the one that started last), or none."""
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    events = sorted(cpu)
    open_ops: list = []  # heap of (-start, end, name)
    totals = collections.defaultdict(float)
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(events) and events[i][0] <= mid:
            heapq.heappush(open_ops, (-events[i][0], events[i][1], events[i][2]))
            i += 1
        # ops that ended before this middle are done for every later one too
        live = [op for op in open_ops if op[1] >= mid]
        if len(live) != len(open_ops):
            open_ops = live
            heapq.heapify(open_ops)
        label = _label(open_ops[0][2]) if open_ops else "no host op"
        totals[label] += (b - a) * 1e-6
    return [[n[:160], s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
