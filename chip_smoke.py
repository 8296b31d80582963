#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each failing the run with a non-zero exit:
  1. card: name and power limit, TF32 settings, versions;
  2. build: the hand-written kernels from ``realtime_whisper_asr_tpu_torch/csrc``
     with nvcc for sm_90a;
  3. the log-mel kernel against its plain torch version and an f64 numpy
     oracle at 8/16/30 s x 80/128 mels, with times;
  4. golden parity at f32: the committed test-tiny weights must reproduce the
     recorded offline tokens and streaming text of tests/fixtures/golden;
  5. the main path at full width: large-v3 in bf16 with seeded random weights,
     one offline 16 s transcribe and an 8 s stream at 1 s chunks through
     OnlineASRProcessor, with every kernel launch counted.
Prints one ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when CUDA
is absent. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def speechy_audio(seconds: float, seed: int = 0) -> np.ndarray:
    """Synthetic speech-like signal: AM-modulated harmonics + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t))
    sig = sig * env + 0.05 * rng.standard_normal(t.shape)
    return (0.5 * sig / np.max(np.abs(sig))).astype(np.float32)


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """The golden fixture's deterministic synthetic clips."""
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


def logmel_oracle(audio: np.ndarray, n_mels: int) -> np.ndarray:
    """Whisper log-mel at float64 with numpy's FFT."""
    from realtime_whisper_asr_tpu_torch.ops import mel as melmod

    audio = np.asarray(audio, np.float64)
    padded = np.pad(audio, (200, 200), mode="reflect")
    n_frames = len(audio) // 160
    idx = np.arange(n_frames)[:, None] * 160 + np.arange(400)[None, :]
    frames = padded[idx] * melmod.hann_window(400).astype(np.float64)
    spec = np.fft.rfft(frames, axis=-1)
    mel = (spec.real ** 2 + spec.imag ** 2) @ melmod.mel_filterbank(n_mels, 400).astype(np.float64).T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def check_logmel_close(ours: np.ndarray, ref: np.ndarray, what: str) -> None:
    """Energy-aware tolerances (as tests/test_logmel.py): tight on bins within
    ~4 decades of the peak, bounded elsewhere."""
    diff = np.abs(ours - ref)
    hot = ref > 0.3
    if not hot.any():
        raise AssertionError(f"{what}: no hot bins")
    if diff[hot].max() >= 2e-2 or diff.mean() >= 3e-3 or diff.max() >= 0.5:
        raise AssertionError(f"{what}: hot max {diff[hot].max():.3g}, mean "
                             f"{diff.mean():.3g}, max {diff.max():.3g}")


def time_cuda_ms(fn, reps: int = 30) -> float:
    """Median device time of fn() in ms: CUDA events around each call, with
    the 50 MB L2 flushed before each (the main path finds it cold). A ~1 ms
    spin kernel ahead of the start event keeps the card busy while the host
    enqueues the events and fn's launches, so the span holds device time
    only, not Python's launch overhead."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class FailOnLog(logging.Handler):
    """Records the streaming loop's swallowed exceptions, which would
    otherwise reset the stream silently."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list[str] = []

    def emit(self, record):
        self.records.append(record.getMessage())


def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    # cuBLAS f32 stays IEEE (PyTorch's default, set here for the plain
    # log-mel oracle); cuDNN keeps its TF32 default, as a user's process
    # would: the model's conv stem turns TF32 off for itself
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (default; the port's "
          f"conv stem runs without it) cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} card(s): {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from realtime_whisper_asr_tpu_torch.ops import logmel

    t0 = time.perf_counter()
    path = logmel.build_kernel()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    log = path + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")


def phase_logmel() -> dict:
    import torch

    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.ops import mel as melmod

    rows = {}
    for seconds in (8, 16, 30):
        for n_mels in (80, 128):
            audio = speechy_audio(seconds)
            a = torch.from_numpy(audio).cuda()
            kern = logmel.log_mel_spectrogram(a, n_mels)
            plain = logmel.log_mel_spectrogram_plain(a, n_mels)
            torch.cuda.synchronize()
            oracle = logmel_oracle(audio, n_mels)
            kern_np, plain_np = kern.cpu().numpy(), plain.cpu().numpy()
            if kern_np.shape != (len(audio) // 160, n_mels):
                raise AssertionError(f"kernel output shape {kern_np.shape}")
            check_logmel_close(kern_np, oracle, f"kernel vs f64 oracle {seconds}s/{n_mels}")
            check_logmel_close(plain_np, oracle, f"plain vs f64 oracle {seconds}s/{n_mels}")
            check_logmel_close(kern_np, plain_np, f"kernel vs plain {seconds}s/{n_mels}")
            err = float(np.abs(kern_np - plain_np).max())

            window = torch.hann_window(400, device="cuda")
            mel_t = logmel._bases(a.device, n_mels)[2]

            def library():  # yardstick only: the port never calls torch.stft
                spec = torch.stft(a, 400, 160, window=window, center=True, pad_mode="reflect",
                                  return_complex=True)[:, :-1]
                return torch.log10(torch.clamp(spec.abs().square().t() @ mel_t, min=1e-10))

            # the work of K1's design: a dense real DFT as two f32 products
            # (an FFT would need ~20x fewer operations), then each mel filter
            # over its nonzero bins only, as the kernel sums it
            n_frames = len(audio) // 160
            nnz = int(np.count_nonzero(melmod.mel_filterbank(n_mels, 400)))
            flops = 2 * n_frames * 400 * 201 * 2 + 2 * n_frames * nnz
            nbytes = 4 * (len(audio) + 2 * 400 * 201 + nnz + 2 * n_mels + n_frames * n_mels)
            row = {
                "max_abs_err": err,
                "ms": time_cuda_ms(lambda: logmel._log10_mel_kernel(a, n_mels)),
                "plain_ms": time_cuda_ms(lambda: logmel._log10_mel_plain(a, n_mels)),
                "library_ms": time_cuda_ms(library),
                "bound_ms": 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES),
                "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes",
            }
            rows[(seconds, n_mels)] = row
            print(f"logmel {seconds:2d} s / {n_mels:3d} mels: kernel_ms {row['ms']:.5f} "
                  f"plain_ms {row['plain_ms']:.5f} library_ms {row['library_ms']:.5f} "
                  f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']}) max_err {err:.3g}")
    silence = logmel.log_mel_spectrogram(torch.zeros(SR, device="cuda"), 80).cpu().numpy()
    if not np.allclose(silence, silence.flat[0]):
        raise AssertionError("silence does not give a constant floor")
    print("logmel: all 6 cases within tolerance of the plain version and the f64 oracle; "
          "silence is a constant floor")
    return rows


def run_stream(asr, audio: np.ndarray, guard: FailOnLog, tick_ms: list | None = None) -> str:
    import torch

    from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

    proc = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0))
    pieces = []
    for pos in range(0, len(audio), SR):
        proc.insert_audio_chunk(audio[pos : pos + SR])
        t0 = time.perf_counter()
        _, _, txt = proc.process_iter()
        torch.cuda.synchronize()
        if tick_ms is not None:
            tick_ms.append(1e3 * (time.perf_counter() - t0))
        if txt:
            pieces.append(txt)
    _, _, txt = proc.finish()
    if txt:
        pieces.append(txt)
    if guard.records:
        raise AssertionError(f"streaming loop swallowed an exception: {guard.records}")
    return asr.sep.join(pieces).strip()


def phase_golden(guard: FailOnLog) -> None:
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        recorded = json.load(f)
    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cuda",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    for rec in recorded["clips"]:
        audio = golden_audio(rec["idx"])
        offline = asr.transcribe(audio)
        if offline.tokens != rec["offline_tokens"]:
            raise AssertionError(f"clip {rec['idx']}: offline tokens {offline.tokens} "
                                 f"!= recorded {rec['offline_tokens']}")
        streaming = run_stream(asr, audio, guard)
        if streaming != rec["streaming_text"]:
            raise AssertionError(f"clip {rec['idx']}: streaming text {streaming!r} "
                                 f"!= recorded {rec['streaming_text']!r}")
    ticks = 3 * (1 + len(golden_audio(0)) // SR)
    if asr.counters["ticks"] != ticks:
        raise AssertionError(f"golden: {asr.counters['ticks']} ticks, expected {ticks}")
    print(f"golden f32: offline tokens and streaming text of 3 clips equal the recorded "
          f"fixture ({ticks} ticks)")


def phase_full_width(guard: FailOnLog) -> int:
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.ops import logmel

    t0 = time.perf_counter()
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0)
    asr.transcribe_kargs["max_total_tokens"] = 32  # random weights never emit EOT
    torch.cuda.synchronize()
    print(f"large-v3 bf16: random init in {time.perf_counter() - t0:.1f} s")
    results = []
    transcribe = asr.transcribe

    def recording_transcribe(*args, **kwargs):
        results.append(transcribe(*args, **kwargs))
        return results[-1]

    asr.transcribe = recording_transcribe
    offline_audio = np.concatenate([golden_audio(i) for i in range(2)])  # 16 s
    stream_audio = golden_audio(2)  # 8 s
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, with the launch counts read around it
    logmel.logmel_launches = 0
    t0 = time.perf_counter()
    asr.transcribe(offline_audio)
    torch.cuda.synchronize()
    offline_s = time.perf_counter() - t0
    tick_ms: list[float] = []
    run_stream(asr, stream_audio, guard, tick_ms)
    launches = logmel.logmel_launches
    # ----

    ticks = 1 + len(stream_audio) // SR
    if asr.counters["ticks"] != ticks or len(results) != ticks:
        raise AssertionError(f"{asr.counters['ticks']} ticks and {len(results)} results, "
                             f"expected {ticks}")
    if launches != asr.counters["ticks"]:
        raise AssertionError(f"logmel launched {launches} times for {ticks} encoded windows")
    for res in results:
        if not res.tokens or not all(0 <= t < asr.cfg.n_vocab for t in res.tokens):
            raise AssertionError(f"tokens out of range or empty: {res.tokens}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # per-layer readings, outside the counted run
    audio_dev = torch.from_numpy(asr._pad_window(offline_audio)).cuda()
    xa = asr._logmel_encode(audio_dev)
    if xa.shape != (1, 800, 1280) or not bool(torch.isfinite(xa).all()):
        raise AssertionError(f"encoder output {tuple(xa.shape)} not finite / wrong shape")
    with torch.inference_mode():
        encode_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            asr._logmel_encode(audio_dev)
            torch.cuda.synchronize()
            encode_s.append(time.perf_counter() - t0)
        encode_ms = 1e3 * float(np.median(encode_s))
        opts = asr._make_opts()
        plan = D.plan_window(asr.cfg, opts)
        aux = torch.from_numpy(plan.aux).cuda()

        def decode():
            return D.greedy_decode(asr.model, xa, opts, plan, aux, asr._extra_suppress)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = decode()
        decode_s = time.perf_counter() - t0
        # device time of the same encode and decode, for the card's busy share
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        busy = {}
        for name, fn in (("encode", lambda: asr._logmel_encode(audio_dev)),
                         ("decode", decode)):
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()  # kernels, not the ops launching them
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if not events:
                print(f"large-v3 bf16: {name} device time not measured (no kernels traced)")
                continue
            busy[name] = sum(e.self_device_time_total for e in events) / 1e3
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
            print(f"large-v3 bf16: {name} device time {busy[name]:.2f} ms, top kernels: "
                  + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                              for e in top))
    n_tokens = int(res.lengths[0]) - int(res.tokens[0][res.lengths[0] - 1] == asr.cfg.eot)
    print(f"large-v3 bf16: offline 16 s transcribe {offline_s:.2f} s (first call), "
          f"{len(results[0].tokens)} tokens; stream of {ticks - 1} ticks, p50 tick "
          f"{np.median(tick_ms):.1f} ms; logmel launches {launches} = encoded windows")
    share = {k: f"{v / wall:.0%}" if k in busy else "not measured"
             for k, v, wall in (("encode", busy.get("encode", 0), encode_ms),
                                ("decode", busy.get("decode", 0), 1e3 * decode_s))}
    print(f"large-v3 bf16: encode_ms (16 s bucket, log-mel + encoder, host clock to "
          f"sync, median of 5) {encode_ms:.2f} (card busy {share['encode']}); "
          f"decode {1e3 * decode_s / n_tokens:.2f} ms per sampled token over {n_tokens} "
          f"(prefill included; card busy {share['decode']}); "
          f"max_memory_allocated {peak_gib:.2f} GiB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    guard = FailOnLog()
    logging.getLogger().addHandler(guard)
    t_start = time.perf_counter()
    kind = phase_card()
    phase_build()
    rows = phase_logmel()
    phase_golden(guard)
    launches = phase_full_width(guard)
    main_case = rows[(16, 128)]  # the offline clip's window bucket at large-v3
    entry = {
        "name": "logmel", "route": "cuda",
        "source": "realtime_whisper_asr_tpu_torch/csrc/logmel.cu",
        "replaces": "realtime_whisper_asr_tpu/ops/logmel.py:76",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }
    entry.update(kernel_ms=entry["ms"], max_err=entry["max_abs_err"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
