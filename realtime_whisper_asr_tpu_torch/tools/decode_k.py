"""How many decode steps one CUDA graph should hold (``DecodeLoop``'s K).

    python -m realtime_whisper_asr_tpu_torch.tools.decode_k    # one CUDA card

A window's loop costs its steps, one host check per K steps (the card idles
from the end of one replay until the host has read the check and launched
the next), and, when EOT ends the loop between two checks, the rest of the
last replay, whose steps change nothing but run all the same. Random
weights never emit EOT, so this tool makes the card's loop end after n
steps as an EOT would: the aux bundle on the card caps each row at n
sampled tokens after the first, while the host's bound stays the plan's
(31 steps at the 32-token cap) and the host learns of the end only at a
check. For large-v3 with seeded random weights, in bf16 and int4, on the
8 s window, it measures for each K (the K in turns, to cancel drift):

- the host-clock time of the window's decode (prefill, loop, result copy)
  for n in ``LOOP_STEPS``, median of ``REPS``;
- the device time of one step (CUDA events around replays of 32 steps);
- the card's idle per check: ``ROUNDS`` replays each followed by the loop's
  check, less the same replays queued at once, over ``ROUNDS``.

Prints one line per tier and K, then per n the K with the least time.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

KS = (1, 2, 4, 8, 16)
LOOP_STEPS = (2, 4, 8, 16, 31)
REPS = 5
ROUNDS = 16


def _host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def measure(quantization) -> dict:
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization=quantization)
    asr.transcribe_kargs["max_total_tokens"] = 32
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(8 * 16000)).astype(np.float32)
    with torch.inference_mode():
        xa = asr._logmel_encode(torch.from_numpy(asr._pad_window(audio)).cuda())
    opts = asr._make_opts()
    plan = D.plan_window(asr.cfg, opts)
    loops = {k: D.DecodeLoop(k=k) for k in KS}
    auxes = {}
    for n in LOOP_STEPS:
        aux = plan.aux.copy()
        aux[D.AUX_TOK + 4] = n + 1  # the card's loop ends after n steps
        auxes[n] = torch.from_numpy(aux).cuda()[None]

    def decode(k, n):
        return D._decode_window(asr.model, opts, xa, auxes[n], plan, asr._extra_suppress, None,
                                loops[k], captured=True).cpu()

    for k in KS:
        decode(k, LOOP_STEPS[-1])  # captures
    times = {(k, n): [] for k in KS for n in LOOP_STEPS}
    steps, idle = {k: [] for k in KS}, {k: [] for k in KS}
    for rep in range(REPS):
        for k in (KS if rep % 2 == 0 else KS[::-1]):
            for n in LOOP_STEPS:
                times[k, n].append(_host_ms(lambda: decode(k, n)))
            # the loop has ended: each replay's steps are no-ops, the same kernels
            (run,) = loops[k]._graphs.values()
            st = run.state
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(32 // k):
                run.run_k()
            end.record()
            end.synchronize()
            steps[k].append(start.elapsed_time(end) / (32 // k * k))

            def checked():
                for _ in range(ROUNDS):
                    run.run_k()
                    bool(st.finished.all() | (st.pos >= st.max_total))

            def unchecked():
                for _ in range(ROUNDS):
                    run.run_k()
                torch.cuda.synchronize()

            idle[k].append((_host_ms(checked) - _host_ms(unchecked)) / ROUNDS)
    return {k: {"step_ms": float(np.median(steps[k])), "idle_ms": float(np.median(idle[k])),
                "capture_s": loops[k].stats["capture_s"],
                "window_ms": {n: float(np.median(times[k, n])) for n in LOOP_STEPS}}
            for k in KS}


def main() -> None:
    print(torch.cuda.get_device_name(0))
    for quantization in (None, "int4"):
        rows = measure(quantization)
        label = f"large-v3 {quantization or 'bf16'}"
        for k, r in rows.items():
            print(f"{label} K={k:2d}: {r['step_ms']:.3f} ms a step on the card, "
                  f"{r['idle_ms']:.3f} ms of idle per check, capture {r['capture_s']:.2f} s; "
                  f"window decode (host clock, median of {REPS}) by loop steps n: "
                  + ", ".join(f"{n}: {ms:.2f}" for n, ms in r["window_ms"].items()))
        for n in LOOP_STEPS:
            best = min(KS, key=lambda k: rows[k]["window_ms"][n])
            print(f"{label}: loop of {n} steps ended on the card, least time at K = {best} "
                  f"({rows[best]['window_ms'][n]:.2f} ms; K = 1: "
                  f"{rows[1]['window_ms'][n]:.2f}, K = 8: {rows[8]['window_ms'][n]:.2f}; "
                  f"{math.ceil(LOOP_STEPS[-1] / best)} checks at most)")
        mean = {k: np.mean(list(rows[k]["window_ms"].values())) for k in KS}
        print(f"{label}: mean over n by K: " + ", ".join(f"{k}: {v:.2f}" for k, v in mean.items())
              + f"; least at K = {min(mean, key=mean.get)}")


if __name__ == "__main__":
    main()
