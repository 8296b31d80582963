"""The readings per-layer metrics take from a run: the recorder's notes, the
decode loop's counters, the work of the window's dispatches, and the trace.

Each reader returns None where the run holds nothing to read (no batched
dispatch in a one-stream run, no complete dispatch in the trace), and the
harness then leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses
import re
import statistics
from typing import Optional

from portbench.core.work import roofline_s


@dataclasses.dataclass
class RunData:
    ctx: object
    cfg: dict
    rec: object
    trace: object  # core.trace.TraceData or None
    window: list  # dispatches started inside the window
    work: dict  # dispatch id -> core.work.DispatchWork, where its results are known

    @property
    def window_s(self) -> float:
        """The window's wall time less the traced span."""
        a, b = self.ctx.extra.get("trace_span", (0.0, 0.0))
        return self.ctx.t_w1 - self.ctx.t_w0 - (b - a)

    def untraced(self, t: float) -> bool:
        """Whether host time ``t`` lies outside the traced span (the
        profiler slows what runs under it, so the window's readings leave
        that span out; the trace's readings take it alone)."""
        a, b = self.ctx.extra.get("trace_span", (0.0, 0.0))
        return not a <= t < b

    def traced(self) -> list:
        """Dispatches wholly inside the trace whose work is known."""
        if self.trace is None:
            return []
        return [self.work[i] for i in sorted(self.trace.complete) if i in self.work]


def host_ms(run: RunData) -> Optional[float]:
    ms = [m for t, m in run.rec.host_ms if run.untraced(t)]
    return statistics.fmean(ms) if ms else None


def dispatch_ms(run: RunData) -> Optional[float]:
    ms = [1e3 * (d.t1 - d.t0) for d in run.window if d.t1]
    return statistics.fmean(ms) if ms else None


def captures(run: RunData) -> Optional[float]:
    if not run.ctx.loop0 or not run.ctx.loop1:
        return None
    return float(run.ctx.loop1["captures"] - run.ctx.loop0["captures"])


def encode_ms_per_row(run: RunData) -> Optional[float]:
    works = run.traced()
    rows = sum(w.rows_encoded for w in works)
    if not rows:
        return None
    return 1e3 * sum(run.trace.encode_seconds(w.did) for w in works) / rows


def decode_ms_per_token(run: RunData) -> Optional[float]:
    works = run.traced()
    tokens = sum(w.new_tokens for w in works)
    if not tokens:
        return None
    s = sum(run.trace.dispatch_seconds(w.did) - run.trace.encode_seconds(w.did) for w in works)
    return 1e3 * s / tokens


def _matcher(patterns):
    rx = [re.compile(p) for p in patterns]
    return lambda name: any(r.search(name) for r in rx)


def kernel_roofline(run: RunData, patterns, bound_of) -> Optional[float]:
    """100 x the least time of the work (``bound_of(work)``, seconds) over
    the device time of the kernels whose names match ``patterns``, over the
    dispatches wholly inside the trace."""
    works = run.traced()
    names = _matcher(patterns)
    t = sum(run.trace.dispatch_seconds(w.did, names) for w in works)
    if not works or t <= 0:
        return None
    return 100.0 * sum(bound_of(w) for w in works) / t


def logmel_roofline(run: RunData, patterns) -> Optional[float]:
    bw = float(run.cfg["peaks"]["hbm_bytes_per_s"])
    return kernel_roofline(run, patterns, lambda w: w.logmel_bytes / bw)


def int8_mm_roofline(run: RunData, patterns) -> Optional[float]:
    peaks = run.cfg["peaks"]
    return kernel_roofline(run, patterns, lambda w: roofline_s(
        w.gemms, float(peaks["int8_ops_per_s"]), float(peaks["hbm_bytes_per_s"])))


def idle_pct(run: RunData) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run: RunData) -> Optional[float]:
    """The model FLOPs of the window's dispatches over the window's wall
    time and the configuration's peak."""
    works = [run.work[d.did] for d in run.window if d.did in run.work]
    if not works:
        return None
    peak = float(run.cfg["peaks"]["model_flops_per_s"])
    return 100.0 * sum(w.flops for w in works) / run.window_s / peak
