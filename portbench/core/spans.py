"""The program's own spans in a run's window.

The program records a span at each of its layers' boundaries into a ring
in memory (``realtime_whisper_asr_tpu_torch.utils.profiling``: name, start
and end on ``time.perf_counter()``, the benchmark's host clock, parent, and
``rid``, the tick the span serves: ``asr.dispatch`` draws it and the tick's
``asr.finalize`` takes the same). The readings here keep the spans that
started inside the window and outside the traced span (the profiler slows
what runs under it), grouped by ``rid``. A program that keeps no ring (an
older commit), or a ring that dropped any span of the window, gives None,
and the metrics that read it are left out of the line.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional


def _program_ring():
    """(the ring's spans, the count it dropped), or None for a program
    without one."""
    try:
        from realtime_whisper_asr_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "spans", None)
    dropped = getattr(profiling, "spans_dropped", None)
    if snapshot is None or dropped is None:
        return None
    return snapshot(), dropped()


def window_spans(run) -> Optional[dict]:
    """rid -> the spans of that tick that started inside the window and
    outside the traced span; None where the program keeps no spans or its
    ring dropped a span of the window (it drops the oldest end first, so a
    kept span that ended before the window vouches for the rest)."""
    got = _program_ring()
    if got is None:
        return None
    ring, dropped = got
    ctx = run.ctx
    if dropped and (not ring or ring[0].t1 >= ctx.t_w0):
        return None
    out = collections.defaultdict(list)
    for s in ring:
        if s.rid is not None and ctx.t_w0 <= s.t0 < ctx.t_w1 and run.untraced(s.t0):
            out[s.rid].append(s)
    return dict(out)


def _first(spans: list, name: str):
    return next((s for s in spans if s.name == name), None)


def mean_ms_per(run, root: str, names: tuple) -> Optional[float]:
    """Mean, over the window's ticks with a ``root`` span (``asr.dispatch``
    or ``asr.finalize``), of the ms their spans named in ``names`` sum to."""
    groups = window_spans(run)
    if groups is None:
        return None
    ms = [1e3 * sum(s.t1 - s.t0 for s in g if s.name in names)
          for g in groups.values() if _first(g, root) is not None]
    return statistics.fmean(ms) if ms else None


def hold_ms(run) -> Optional[float]:
    """Mean over the window's ticks of the ms from the end of their
    ``asr.dispatch`` to the start of their ``asr.finalize``: how long a
    finished dispatch waits in the async pipeline before it is collected."""
    groups = window_spans(run)
    if groups is None:
        return None
    ms = []
    for g in groups.values():
        d, f = _first(g, "asr.dispatch"), _first(g, "asr.finalize")
        if d is not None and f is not None:
            ms.append(1e3 * (f.t0 - d.t1))
    return statistics.fmean(ms) if ms else None


def loop_counter_delta(run, key: str) -> Optional[float]:
    """A decode-loop counter at the window's end less at its start; None
    where the program's loop does not count it."""
    a, b = run.ctx.loop0.get(key), run.ctx.loop1.get(key)
    return None if a is None or b is None else float(b - a)
