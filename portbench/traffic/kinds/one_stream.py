"""``one_stream``: one user replaying a recording as fast as results come
back, a closed loop.

``VACOnlineASRProcessor`` over an async-pipelined ``OnlineASRProcessor``
(``core.system.build_one_stream``), fed packets of ``packet_s`` back to
back: ``insert_audio_chunk``, then ``process_iter``. The ASR backend under
it is the configuration's model family's (``ctx.family``): its build, its
recorder wraps and its loop counters. A packet is due when it is fed. The
feeds the stream's first ``warmup_cycles`` cycles of
the mix's utterance lengths (each cycle deals every length once, so the
warm-up meets every utterance length the window will, and the window opens at
the start of a cycle whatever the seed's order); the window runs packets
until ``--seconds`` have passed; the drain goes on feeding until the
window's packets are covered.
"""

from __future__ import annotations

import math

from portbench.core import speech, system, window


def run(ctx) -> None:
    import torch

    t, rec, family = ctx.traffic, ctx.rec, ctx.family
    clock = rec.clock
    ctx.extra["t_build0"] = clock()
    asr = ctx.asr = family.build(ctx.config, ctx.seed, ctx.device)
    ctx.extra["built_s"] = clock() - ctx.extra["t_build0"]
    vac = system.build_one_stream(asr, t)
    packet_s, audio_s = float(t["packet_s"]), float(t["audio_s"])
    mix = speech.UtteranceMix.from_dict(t)
    stream = speech.make_stream(ctx.seed, 0, mix, audio_s, ctx.device)
    family.attach(rec, asr)
    rec.attach_stream(0, vac, None)
    packets = window.packets_for(stream, 0, 0.0, packet_s, math.ceil(audio_s / packet_s))
    ctx.extra["packets"] = packets
    it = iter(packets)

    def tick(counted: bool):
        p = next(it, None)
        if p is None:
            raise RuntimeError(f"the stream's {audio_s} s of audio ran out: raise audio_s")
        p.counted = counted
        p.due = p.fed = clock()
        inside0 = rec.asr_inside_s
        vac.insert_audio_chunk(stream.audio[p.a:p.b])
        vac.process_iter()
        if counted:
            rec.host_ms.append((p.fed, 1e3 * ((clock() - p.fed) - (rec.asr_inside_s - inside0))))

    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # up to the first utterance of a cycle of the mix's lengths
    first = stream.spans[int(t["warmup_cycles"]) * mix.strata][0]
    for _ in range(first // int(round(packet_s * speech.SR))):
        tick(False)
    ctx.t_w0 = clock()
    ctx.loop0 = family.loop_stats(asr)
    traced = ctx.tracer is None
    while clock() - ctx.t_w0 < ctx.seconds:
        if not traced and clock() - ctx.t_w0 >= float(t["trace_at"]) * ctx.seconds:
            t_tr = clock()
            ctx.tracer.start()
            t_stop = clock() + float(t["trace_s"])
            while clock() < t_stop:
                tick(True)
            ctx.tracer.stop()
            ctx.extra["trace_span"] = (t_tr, clock())
            traced = True
            continue
        tick(True)
    ctx.t_w1 = clock()
    ctx.loop1 = family.loop_stats(asr)
    ctx.t_end = window.wait_drain(rec, packets, ctx.t_w1, step=lambda: tick(False))
