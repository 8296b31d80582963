"""What every traffic kind shares: the run's context, the packet schedule,
coverage of packets by applied ticks, and the drain after the window.

A packet of a stream is covered by the first tick applied whose request was
prepared after the stream had handed the packet's last speech sample to its
processor. Its latency runs from its due time to that apply. A packet no
applied tick covers by the end of the drain has failed, and enters the
latencies at the drain's end.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Optional

from portbench.core.record import SR, Packet, Recorder

#: the longest the drain after the window waits for late results
DRAIN_S = 5.0


@dataclasses.dataclass
class Ctx:
    """A run's inputs and what its traffic kind reports back."""

    cell: object  # spec.Cell
    seed: int
    seconds: float
    device: object
    rec: Recorder
    tracer: object = None  # core.trace.Tracer when tracing
    log: object = print
    family: object = None  # the configuration's model family (spec.model_family)
    # filled by the traffic kind
    asr: object = None
    t_w0: float = 0.0  # the window's first packet (host clock)
    t_w1: float = 0.0  # the window's end
    t_end: float = 0.0  # the drain's end
    loop0: dict = dataclasses.field(default_factory=dict)  # the family's loop_stats at t_w0
    loop1: dict = dataclasses.field(default_factory=dict)  # ... at t_w1
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def config(self) -> dict:
        return self.cell.config


def packets_for(stream, index: int, t0: float, packet_s: float, n_packets: int) -> list[Packet]:
    """``n_packets`` packets of ``packet_s`` of a stream whose first is due
    at ``t0``."""
    step = int(round(packet_s * SR))
    out = []
    for k in range(n_packets):
        a, b = k * step, min((k + 1) * step, len(stream.audio))
        if a >= b:
            break
        out.append(Packet(index, t0 + k * packet_s, a, b, stream.last_speech(a, b)))
    return out


def coverage(rec: Recorder, packets: list[Packet]) -> list[Optional[float]]:
    """For each packet, the apply time of the tick that covers it (None:
    none yet; a packet with no speech: its feed time)."""
    applied: dict[int, list] = {}
    with rec.lock:
        for r in rec.reqs:
            if not r.abandoned and r.dispatch is not None:
                applied.setdefault(r.stream, []).append(r)
    for reqs in applied.values():
        reqs.sort(key=lambda r: r.rid)
    keys = {s: [r.drained for r in reqs] for s, reqs in applied.items()}
    out = []
    for pk in packets:
        if pk.speech_end < 0:
            out.append(pk.fed)
            continue
        reqs = applied.get(pk.stream, [])
        i = bisect.bisect_left(keys.get(pk.stream, []), pk.speech_end)
        t = None
        # the first request that held the sample; if it never applied (still
        # in flight) the packet is not covered yet
        if i < len(reqs) and reqs[i].t_apply is not None:
            t = reqs[i].t_apply
        out.append(t)
    return out


def speech_counted(packets: list[Packet]) -> list[Packet]:
    return [p for p in packets if p.counted and p.speech_end >= 0]


def wait_drain(rec: Recorder, packets: list[Packet], t_w1: float, step=None) -> float:
    """Wait (or call ``step()``, a closed loop's next iteration) until every
    counted speech packet is covered or ``DRAIN_S`` has passed since
    ``t_w1``; returns the drain's end."""
    todo = speech_counted(packets)
    while True:
        now = rec.clock()
        if all(t is not None for t in coverage(rec, todo)) or now - t_w1 >= DRAIN_S:
            return now
        if step is not None:
            step()
        else:
            time.sleep(0.05)


def latencies_ms(rec: Recorder, packets: list[Packet], t_end: float) -> tuple[list, int]:
    """(latency ms of each counted speech packet, failed packets): a failed
    packet's latency runs to ``t_end``."""
    todo = speech_counted(packets)
    lat, failed = [], 0
    for pk, t in zip(todo, coverage(rec, todo)):
        if t is None:
            failed += 1
            t = t_end
        lat.append(1e3 * (t - pk.due))
    return lat, failed


def throughput(rec: Recorder, packets: list[Packet], t_w0: float, t_w1: float) -> float:
    """Audio seconds of the counted packets done by ``t_w1`` (a speech
    packet when a tick covering it was applied, a silent one when fed), over
    the window's wall time."""
    counted = [p for p in packets if p.counted]
    done = sum((p.b - p.a) / SR for p, t in zip(counted, coverage(rec, counted))
               if t is not None and t <= t_w1)
    return done / max(t_w1 - t_w0, 1e-9)


def percentile(values: list, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    if not values:
        return float("nan")
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)
