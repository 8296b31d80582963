"""Long-session stability soak: drive a StreamingApp session for many
simulated minutes and check that nothing drifts.

    python -m realtime_whisper_asr_tpu_torch.tools.soak [--minutes 10] \\
        [--chunk 1.0] [--drift-x 3.0] [--rss-mb 400] [--model test-tiny] \\
        [--json out.json] [--cpu]

Port of the JAX package's ``tools/soak.py``: what the scenario runs cannot
see in a minute or less (per-tick host cost creeping with the transcript's
length, unbounded buffers, registries that leak, RSS growth). One chunk a
tick goes through ``StreamingApp.process_chunk`` (synchronous ticks); on the
card unless ``--cpu``, and without CUDA and without ``--cpu`` it raises.

Checks (exit 1 on failure):
  - per-tick latency drift: the median of the last decile against the
    second decile's (the first decile is the warm-up) stays under
    ``--drift-x``
  - the audio buffer bounded by the trimming config at every tick
  - the skip detector's history, the hypothesis buffers and the token
    history bounded
  - at the session's end no dispatched window left unfinalised, and no
    result copy outstanding on the decode loop's copy stream
  - no new decode-loop shape after the warm-up: the ``LoopKey``s the ASR's
    ``DecodeLoop`` is asked for (each a CUDA graph on the card) grow by at
    most 4 after the warm-up decile (``graph_keys``); keys captured again
    after ``MAX_GRAPHS`` others evicted them are reported (``recaptures``)
  - RSS growth after the warm-up under ``--rss-mb``
"""

from __future__ import annotations

import argparse
import collections
import json
import resource
import sys
import time


def synthetic_speech_cycle(rng, seconds: float, sr: int = 16000):
    """Speech-like audio with pauses (modulated harmonics + noise bursts),
    varied every call so the dedup gate and skip detector see fresh content."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(110, 220)
    voiced = np.zeros_like(t)
    for h in range(1, 5):
        voiced += np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h
    # syllable-rate amplitude modulation + a silence gap somewhere
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.5, 4.5) * t))
    gap0 = rng.uniform(0.1, seconds - 0.4)
    env[(t > gap0) & (t < gap0 + 0.3)] = 0.0
    x = 0.25 * voiced * env + 0.02 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


class LoopKeyProbe:
    """Watches the loop shapes a ``DecodeLoop`` is asked for: the distinct
    ``LoopKey``s (``keys``), and the recaptures a ``MAX_GRAPHS``-entry LRU
    of them makes (a key asked for again after others evicted it), the
    policy ``DecodeLoop`` keeps its graphs by on the card."""

    def __init__(self, loop):
        from realtime_whisper_asr_tpu_torch.models.whisper.decode import MAX_GRAPHS

        self.keys: set = set()
        self.recaptures = 0
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self._max = MAX_GRAPHS
        inner = loop.loop

        def observed(model, key, *args, **kwargs):
            self._observe(key)
            return inner(model, key, *args, **kwargs)

        loop.loop = observed

    def _observe(self, key) -> None:
        if key in self._lru:
            self._lru.move_to_end(key)
            return
        if key in self.keys:
            self.recaptures += 1
        self.keys.add(key)
        self._lru[key] = None
        while len(self._lru) > self._max:
            self._lru.popitem(last=False)


def run_soak(minutes: float, chunk_s: float = 1.0, drift_x: float = 3.0,
             rss_mb: float = 400.0, model: str = "test-tiny", device="cuda",
             config: dict | None = None) -> dict:
    """``minutes`` of simulated audio through a fresh ``StreamingApp`` on
    ``device`` (random weights from seed 0) -> the report. ``config``:
    extra config keys (dotted path -> value) set after the soak's own."""
    import numpy as np

    from realtime_whisper_asr_tpu_torch.app import SessionStats, StreamingApp
    from realtime_whisper_asr_tpu_torch.config import ConfigManager

    cm = ConfigManager(autoload=False)
    cm.set("model.size", model)
    cm.set("performance.display_interval_s", 1e9)
    cm.set("fallback.auto_downgrade", False)  # keep the requested model
    for key, value in (config or {}).items():
        cm.set(key, value)
    app = StreamingApp(config=cm, language="en", device=device)
    proc = app.processor
    online = getattr(proc, "online", proc)
    loop = app.asr.decode_loop
    probe = LoopKeyProbe(loop)
    trim_cap_s = online.buffer_trimming_sec * 2 + 35.0  # trim target + slack

    rng = np.random.default_rng(0)
    n_ticks = int(minutes * 60 / chunk_s)
    lat, buf_s, failures = [], [], []
    stats = SessionStats()
    keys_after_warmup = recaptures_at_warmup = rss_after_warmup = None

    t_all = time.perf_counter()
    for tick in range(n_ticks):
        chunk = synthetic_speech_cycle(rng, chunk_s)
        t0 = time.perf_counter()
        app.process_chunk(chunk, stats, now=tick * chunk_s, separated=True)
        lat.append(time.perf_counter() - t0)
        cur_buf = len(online.audio_buffer) / 16000.0
        buf_s.append(cur_buf)
        if cur_buf > trim_cap_s:
            failures.append(f"audio_buffer {cur_buf:.1f}s > cap {trim_cap_s:.1f}s at tick {tick}")
            break
        if tick == n_ticks // 10:  # end of the warm-up decile
            keys_after_warmup, recaptures_at_warmup = len(probe.keys), probe.recaptures
            rss_after_warmup = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    wall = time.perf_counter() - t_all

    # ---- checks
    dec = max(len(lat) // 10, 1)
    early = float(np.median(lat[dec:2 * dec]))
    late = float(np.median(lat[-dec:]))
    if late > early * drift_x and late - early > 0.02:
        failures.append(f"per-tick latency drifted {early*1e3:.1f} -> {late*1e3:.1f} ms")
    if online._inflight is not None:
        failures.append("a dispatched window was left unfinalised")
    copy_stream = loop._copy_stream
    if copy_stream is not None and not copy_stream.query():
        failures.append("a result copy is outstanding on the decode loop's copy stream")
    keys_end = len(probe.keys)
    if keys_after_warmup is not None and keys_end > keys_after_warmup + 4:
        failures.append(f"loop keys grew {keys_after_warmup} -> {keys_end} after warmup")
    rss_end = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    if rss_after_warmup is not None and rss_end - rss_after_warmup > rss_mb:
        failures.append(f"RSS grew {rss_end - rss_after_warmup:.0f} MB after warmup")
    if app.skip_detector is not None and len(app.skip_detector.history) > 1000:
        failures.append(f"skip history unbounded: {len(app.skip_detector.history)}")
    tb = online.transcript_buffer
    for name, n in (("hyp.buffer", len(tb.buffer)), ("hyp.new", len(tb.new)),
                    ("token_history", len(online._token_history))):
        if n > 2000:
            failures.append(f"{name} unbounded: {n}")

    app.shutdown()
    return {
        "simulated_minutes": minutes,
        "ticks": len(lat),
        "wall_seconds": round(wall, 1),
        "soak_rtf": round(wall / (len(lat) * chunk_s), 4) if lat else None,
        "tick_ms_early": round(early * 1e3, 2),
        "tick_ms_late": round(late * 1e3, 2),
        "audio_buffer_s_max": round(max(buf_s), 1) if buf_s else None,
        "commited_words": len(online.commited),
        "results": stats.results,
        "rss_mb_end": round(rss_end, 1),
        "rss_mb_growth_after_warmup": round(rss_end - (rss_after_warmup or rss_end), 1),
        "graph_keys": keys_end,
        "recaptures": probe.recaptures - (recaptures_at_warmup or 0),
        "failures": failures,
        "ok": not failures,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--chunk", type=float, default=1.0)
    ap.add_argument("--drift-x", type=float, default=3.0)
    ap.add_argument("--rss-mb", type=float, default=400.0)
    ap.add_argument("--model", default="test-tiny")
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)
    report = run_soak(args.minutes, args.chunk, args.drift_x, args.rss_mb, args.model,
                      "cpu" if args.cpu else "cuda")
    print(json.dumps(report, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
