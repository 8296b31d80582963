"""One run of one cell: set-up, warm-up, window and drain (the traffic
kind's), then the metrics, the look for JAX, the release of the program's
state, the comparison with the reference, and the look for JAX again (the
family's check and its reference must load none of it either).

Everything that depends on the model comes from the model family that the
cell's configuration names (``families/<family>.py``, ``ctx.family``): the
traffic kind builds the system with it, the readers take each dispatch's
work count from it, and its check makes the reference's state from the seed
and judges the served tokens. The harness itself is the same for every
family."""

from __future__ import annotations

import gc
import os
import statistics
import time

from portbench.core import readers, spec, window
from portbench.core.record import SR, Recorder
from portbench.core.spec import forbidden_modules


def refuse_jax(when: str) -> None:
    """Raise if a module of JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded {when}: {found}")


def process_start_epoch(fallback: float) -> float:
    """The epoch second this process started (Linux ``/proc``), else
    ``fallback``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return fallback


def _works(family, cfg: dict, rec, dids) -> dict:
    """Work of the dispatches whose rows all came back with their audio, as
    the model family counts it."""
    out = {}
    for did in dids:
        d = rec.dispatches[did]
        rows = [rec.reqs[i] for i in d.rids]
        if rows and all(r.tokens is not None and r.audio is not None and not r.multi_window
                        for r in rows) and len(rows) == d.rows_real:
            out[did] = family.work(cfg, rec, d)
    return out


def run_cell(root: str, bench_path: str, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False,
             log=print) -> dict:
    """Run the cell; returns the result line's object (its last key,
    ``checks``, holds each compared number and its limit). With ``control``
    the lower-precision control stands in the program's place: its choices
    at the served positions are judged, by the same rule and limit."""
    import torch

    cell = spec.load_cell(bench_path, workload, root)
    family = spec.model_family(root, cell.config)
    rec = Recorder(trace=trace)
    tracer = None
    if trace:
        from portbench.core.trace import Tracer

        tracer = Tracer()
    ctx = window.Ctx(cell, seed, float(seconds), device, rec, tracer, log=log, family=family)
    spec.traffic_kind(root, cell.traffic["kind"]).run(ctx)
    log(f"set-up: the system built {ctx.extra.get('built_s')} s after the start of the run's "
        f"set-up, the window opened {ctx.t_w0 - ctx.extra.get('t_build0', ctx.t_w0)} s after it")
    setup_s = (time.time() - (rec.clock() - ctx.t_w0)) - process_start_epoch(t_start)
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    for r in rec.reqs:
        r.counted = r.t_prepare >= ctx.t_w0
    packets = ctx.extra["packets"]
    lat, failed = window.latencies_ms(rec, packets, ctx.t_end)
    attempted = len(window.speech_counted(packets))
    log(f"window {ctx.t_w1 - ctx.t_w0} s, drain {ctx.t_end - ctx.t_w1} s, "
        f"{attempted} speech packets, {failed} failed, "
        f"{len(rec.reqs)} requests, {len(rec.dispatches)} dispatches")
    span = ctx.extra.get("trace_span", (0.0, 0.0))
    timed = [d for d in rec.dispatches
             if ctx.t_w0 <= d.t0 < ctx.t_w1 and not span[0] <= d.t0 < span[1]]
    batches = [d for d in timed if d.kind == "batch"]
    log(f"window dispatches: {len(batches)} batched (mean rows "
        f"{sum(d.rows_real for d in batches) / max(len(batches), 1)}), "
        f"{len(timed) - len(batches)} single windows; mean dispatch "
        f"{1e3 * sum(d.t1 - d.t0 for d in timed) / max(len(timed), 1)} ms; ticks shed "
        f"{ctx.extra.get('shed')}; graph captures "
        f"{ctx.loop1.get('captures', 0) - ctx.loop0.get('captures', 0)}")
    sizes = [rec.reqs[i] for d in timed for i in d.rids if rec.reqs[i].tokens is not None]
    if sizes:
        log(f"window requests: mean audio {statistics.fmean(len(r.audio) for r in sizes) / SR} "
            f"s, prompt {statistics.fmean(len(r.prompt) for r in sizes)}, prefix "
            f"{statistics.fmean(len(r.prefix) for r in sizes)}, served "
            f"{statistics.fmean(len(r.tokens) - len(r.prefix) for r in sizes)} tokens")
    data = None
    if tracer is not None and tracer.prof is not None:
        data = tracer.read()
        log(f"trace: {data.window_s} s, busy {data.busy_s} s, {len(data.complete)} complete "
            f"dispatches; top device ops: {data.device_ops}; idle by host activity: "
            f"{data.idle_gaps}")
    dids = {d.did for d in timed} | (data.complete if data is not None else set())
    run = readers.RunData(ctx, cell.config, rec, data, timed,
                          _works(family, cell.config, rec, dids))
    values = {
        "result_p95_ms": window.percentile(lat, 95),
        "result_p50_ms": window.percentile(lat, 50),
        "audio_throughput": window.throughput(rec, packets, ctx.t_w0, ctx.t_w1),
        "peak_mem_gib": peak / 2**30,
        "setup_s": setup_s,
    }
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    refuse_jax("once the window has closed")
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": peak}
    # the program's state goes before the reference runs
    rec.unwrap()
    ctx.asr = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cfg = cell.config
    t0 = time.perf_counter()
    got = family.check(rec, cfg, seed, device, control)
    refuse_jax("after the reference check")
    log(f"reference check of {got['requests']} requests, {got['positions']} positions in "
        f"{time.perf_counter() - t0} s")
    for note in got["fault_notes"]:
        log(f"structural fault: {note}")
    limits = cfg["limits"]
    gap = "control_widest_gap" if control else "widest_gap"
    if control:
        log(f"the program's own widest gap {got['widest_gap']} (not judged: the control "
            f"stands in its place)")
    checks = {
        gap: {"value": got[gap], "limit": float(limits["widest_gap"])},
        "structure_faults": {"value": got["structure_faults"], "limit": 0},
        "positions": {"value": got["positions"], "limit": int(limits["min_positions"])},
    }
    correct = all(c["value"] <= c["limit"] for k, c in checks.items() if k != "positions") \
        and checks["positions"]["value"] >= checks["positions"]["limit"]
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if data is not None:
        dev["busy_s"], dev["window_s"] = data.busy_s, data.window_s
        out["breakdown"] = {"device_ops": data.device_ops, "idle_gaps": data.idle_gaps}
    out["checks"] = checks
    return out

