#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each failing the run with a non-zero exit:
  1. card: name and power limit, TF32 settings, versions;
  2. build: the hand-written kernels from ``realtime_whisper_asr_tpu_torch/csrc``
     with nvcc for sm_90a;
  3. the log-mel kernel (K1, a real FFT in shared memory) against its plain
     torch version and an f64 numpy oracle at 8/16/30 s x 80/128 mels, a
     ragged last block (801 frames) and a 1 s window, with times at a cold
     and a warm L2 beside its bound and the dense-DFT design's bound;
  4. golden parity at f32: the committed test-tiny weights must reproduce the
     recorded offline tokens and streaming text of tests/fixtures/golden, and
     the pipelined rows: the synchronous, exact and async streams of the 3
     clips under prefix policy "last" commit the recorded words (exact's
     equal to the synchronous stream's);
  5. the main path at full width: large-v3 in bf16 with seeded random weights,
     one offline 16 s transcribe and an 8 s stream at 1 s chunks through
     OnlineASRProcessor, with every kernel launch counted (the decode loop's
     steps as CUDA graphs: the launches of each replay count) and the host
     syncs of each window's decode counted (its dispatch's by torch's sync
     debug mode: the loop's host checks only; its finalize's: one wait for
     the result copy's event, nothing else; at most 1 + ceil((max_new - 1)
     / K) in all); tick p50/p95, decode ms per token, the card's busy
     share, a PhaseTimer split of a tick and the graphs' captures, capture
     seconds and memory, beside the eager loop's figures;
     then the graph path's packed result against the same step run
     uncaptured on the card, bit for bit, at the 16 s and 8 s windows, each
     with no draft, a host draft and a forced device draft (whose tokens
     must come back verbatim);
     then pipelined ticks on the same ASR and graphs: the 8 s stream under
     prefix policy "last", synchronous, exact and async (the device draft)
     in three rounds taken in turns, with K1 launched in each stream; exact
     must commit the synchronous stream's words bit for bit and every async
     run the same words, no exception swallowed; per mode process_iter
     p50/p95, the dispatch-to-apply latency, dispatch and finalize host ms
     and the finalize's wait, captures and the host syncs of each window as
     above;
  6. the packed-int4 kernel family (K2) against its plain versions, bit for
     bit, at the large-v3 decode shapes (M = 1), its prefill spans (M = 2,
     4, 8 and 24), the 16 s cross-K/V shape (M = 800) and the test-tiny
     shapes, with times: ``int4_matmul`` (int8 in, f32 out) and
     ``int4_linear`` (x in bf16 and f32, with and without bias); then a
     profiler count of the kernels one large-v3 ``Int4Linear``
     forward launches at M = 1 and M = 800 (at most 2);
  7. golden parity of the quantized tiers at f32: ``int8-all`` and ``int4``
     on the golden weights reproduce the recorded matrix rows;
  8. the int4 tier at full width: phase 5's run with large-v3 quantized at
     load, K2's launches (replays included) equal to the count the model's
     structure predicts (per layer, 2 cross-K/V linears per encoded window
     and 6 linears per decoder pass: each prefill span, each warm-up step and
     each replayed step, 1 launch at M <= 8 and 2 above), and every K2 code
     path it took among those phase 6 held against the plain version; then
     one async pipelined stream (its device drafts add the 16-slot prefill
     spans), its K2 launches again equal to the prediction and its paths
     held;
  9. the fused matmul chain (K3) against its plain version at T = 800,
     D = 1280, k in {1, 8, 32}, one launch per chain, with times; then the
     port's encoder microbenchmark section (bf16 and int8-all encoder).
Prints one ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when CUDA
is absent. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
#: the eager decode loop that the graph loop replaced (one host sync and
#: ~1,300 launches per token), large-v3 at the 32-token cap on "NVIDIA H100
#: 80GB HBM3, 700.00 W", as PERF.md section 5 records it: printed beside this
#: run's figures
EAGER_LOOP = {
    None: {"tick_p50_ms": 1087.5, "host_ms_per_token": 36.02, "kernel_ms_per_token": 4.84,
           "busy": "13%"},
    "int4": {"tick_p50_ms": 981.4, "host_ms_per_token": 37.85, "kernel_ms_per_token": 4.36,
             "busy": "12%"},
}


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


def time_cuda_ms(fn, reps: int = 30, cold: bool = True) -> float:
    """Median device time of fn() in ms: CUDA events around each call, with
    the 50 MB L2 flushed before each when ``cold`` (the main path finds it
    cold) and left holding the previous call's data otherwise. A ~1 ms spin
    kernel ahead of the start event keeps the card busy while the host
    enqueues the events and fn's launches, so the span holds device time
    only, not Python's launch overhead."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if cold:
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


@contextlib.contextmanager
def sync_warnings():
    """Collects the messages of the host syncs torch's sync debug mode sees
    in the block (it does not see waits on CUDA events)."""
    import torch

    seen: list[str] = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.cuda.set_sync_debug_mode(0)
    seen.extend(str(w.message) for w in caught if "synchroniz" in str(w.message))


class TickProbe:
    """While installed, records for each window the ASR decodes: the host
    syncs of its decode's dispatch (torch's sync debug mode; the loop's host
    checks are the only ones it may make) and of its finalize (the debug
    mode's, none allowed, and its waits on CUDA events, which the debug mode
    does not see: exactly one, the result copy's), whether a graph was
    captured in it, and the ASR's host ms in each half of the tick (plan,
    upload, device draft, encode and the decode's dispatch; the wait and
    the parse) and in the wait; also the aux bundles a device draft was
    written into."""

    def __init__(self, asr):
        self.asr = asr
        self.windows: list[dict] = []
        self.half_ms: dict[str, list[float]] = {"dispatch": [], "finalize": []}
        self.wait_ms: list[float] = []
        self.draft_aux: list = []

    def __enter__(self):
        import torch

        from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

        asr, loop, windows, half = self.asr, self.asr.decode_loop, self.windows, self.half_ms
        self._saved = (D.greedy_decode_dispatch, D.greedy_decode_finalize,
                       D.patch_aux_device_draft, torch.cuda.Event.synchronize)
        dispatch, finalize, patch, event_sync = self._saved
        waits = [0]

        def counted_event_sync(event):
            waits[0] += 1
            t0 = time.perf_counter()
            event_sync(event)
            self.wait_ms.append(1e3 * (time.perf_counter() - t0))

        def counted_dispatch(model, xa, opts, plan, *args, **kwargs):
            checks, captures = loop.stats["checks"], loop.stats["captures"]
            with sync_warnings() as seen:
                handle = dispatch(model, xa, opts, plan, *args, **kwargs)
            handle.probe = {"dispatch": len(seen), "checks": loop.stats["checks"] - checks,
                            "allowed": 1 + math.ceil((plan.max_new - 1) / loop.k),
                            "captured": loop.stats["captures"] > captures}
            return handle

        def counted_finalize(handle):
            before = waits[0]
            with sync_warnings() as seen:
                res = finalize(handle)
            windows.append({**handle.probe, "finalize": len(seen), "waits": waits[0] - before})
            return res

        def counted_patch(aux, *args, **kwargs):
            self.draft_aux.append(aux)  # its draft length is read after the run
            return patch(aux, *args, **kwargs)

        def timed(fn, key):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                half[key].append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        D.greedy_decode_dispatch, D.greedy_decode_finalize = counted_dispatch, counted_finalize
        D.patch_aux_device_draft = counted_patch
        torch.cuda.Event.synchronize = counted_event_sync
        asr._transcribe_window_dispatch = timed(asr._transcribe_window_dispatch, "dispatch")
        asr._transcribe_window_finalize = timed(asr._transcribe_window_finalize, "finalize")
        return self

    def __exit__(self, *exc):
        import torch

        from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

        (D.greedy_decode_dispatch, D.greedy_decode_finalize, D.patch_aux_device_draft,
         torch.cuda.Event.synchronize) = self._saved
        del self.asr._transcribe_window_dispatch, self.asr._transcribe_window_finalize

    def check(self, what: str) -> None:
        """Fails unless every window's finalize made exactly one wait and no
        other sync, and every window that captured no graph made only its
        loop's checks in the dispatch, within the bound in all."""
        bad = [w for w in self.windows
               if w["finalize"] or w["waits"] != 1
               or (not w["captured"] and (w["dispatch"] != w["checks"]
                                          or w["dispatch"] + w["waits"] > w["allowed"]))]
        if bad or not self.windows:
            raise AssertionError(f"{what}: host syncs of a window outside the bound (or no "
                                 f"window): {bad}")

    def syncs(self) -> str:
        return " ".join(f"{w['dispatch']}+{w['waits']}/{w['allowed']}{'*' if w['captured'] else ''}"
                        for w in self.windows)


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
    """Builds the three kernel libraries at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from realtime_whisper_asr_tpu_torch.ops import int4_matmul, logmel, matmul_chain

    t0 = time.perf_counter()
    mods = (logmel, int4_matmul, matmul_chain)
    with ThreadPoolExecutor(len(mods)) as pool:
        paths = list(pool.map(lambda m: m.build_kernel(), mods))
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for path in paths:
        print(f"  {os.path.relpath(path, ROOT)}")
        log = path + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f.read().splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas: {line.strip()}")


#: K1's cases (label, samples, mels): the 8/16/30 s window buckets at both
#: mel counts, a ragged last block (801 frames) and a short window
LOGMEL_CASES = tuple((f"{s} s", s * SR, m) for s in (8, 16, 30) for m in (80, 128)) + (
    ("8 s + 160", 8 * SR + 160, 128), ("1 s", SR, 80))


def logmel_fft_flops(n_frames: int, nnz: int) -> int:
    """f32 operations of K1's FFT design (csrc/logmel.cu), an add or a
    multiply as 1, a complex multiply as 6, an FMA as 2. Per frame: the
    window (400); 25 radix-8 butterflies, each 24 complex adds, 8 complex
    multiplies by W_8 and 8 by W_200 (144); 40 radix-5 butterflies with
    their 5 W_25 twiddles (48 + 30) and 40 without (48); 101 real-split
    pairs (halves 8, W_400 6, the two bins 4, two powers 6); the mel sums,
    2 per nonzero weight. The log10 of each output is not counted."""
    per_frame = 400 + 25 * 144 + 40 * (48 + 30) + 40 * 48 + 101 * 24
    return n_frames * (per_frame + 2 * nnz)


def phase_logmel() -> dict:
    """K1 against its plain version and the f64 oracle at every case, timed
    at a cold and a warm L2 beside the plain version and the library. Bound:
    the FFT design's f32 operations (``logmel_fft_flops``) over 67 TFLOP/s
    against the bytes that must move (audio in, tables, log-mel out) over
    3.35 TB/s; the dense-DFT design's bound beside it."""
    import torch

    from realtime_whisper_asr_tpu_torch.ops import logmel

    rows = {}
    for label, n, n_mels in LOGMEL_CASES:
        audio = speechy_audio(-(-n // SR))[:n]
        a = torch.from_numpy(audio).cuda()
        kern = logmel.log_mel_spectrogram(a, n_mels)
        plain = logmel.log_mel_spectrogram_plain(a, n_mels)
        torch.cuda.synchronize()
        oracle = logmel_oracle(audio, n_mels)
        kern_np, plain_np = kern.cpu().numpy(), plain.cpu().numpy()
        if kern_np.shape != (n // 160, n_mels):
            raise AssertionError(f"kernel output shape {kern_np.shape}")
        what = f"{label}/{n_mels}"
        check_logmel_close(kern_np, oracle, f"kernel vs f64 oracle {what}")
        check_logmel_close(plain_np, oracle, f"plain vs f64 oracle {what}")
        check_logmel_close(kern_np, plain_np, f"kernel vs plain {what}")
        err = float(np.abs(kern_np - plain_np).max())

        window = torch.hann_window(400, device="cuda")
        mel_t = logmel._bases(a.device, n_mels)[2]

        def library():  # yardstick only: the port never calls torch.stft
            spec = torch.stft(a, 400, 160, window=window, center=True, pad_mode="reflect",
                              return_complex=True)[:, :-1]
            return torch.log10(torch.clamp(spec.abs().square().t() @ mel_t, min=1e-10))

        def kernel():
            return logmel._log10_mel_kernel(a, n_mels)

        n_frames = n // 160
        nnz = logmel.mel_table(n_mels)[0].size
        table_bytes = 4 * (logmel.fft_table().size + nnz + 2 * n_mels + 1)
        flops = logmel_fft_flops(n_frames, nnz)
        bound, by = _bound(4 * (n + n_frames * n_mels) + table_bytes, flops, PEAK_F32_FLOPS)
        # the first port's design: a dense real DFT as two f32 products, then
        # each mel filter over its nonzero bins
        dense, _ = _bound(4 * (n + 2 * 400 * 201 + nnz + 2 * n_mels + n_frames * n_mels),
                          2 * n_frames * 400 * 201 * 2 + 2 * n_frames * nnz, PEAK_F32_FLOPS)
        row = rows[(label, n_mels)] = {
            "max_abs_err": err,
            "ms": time_cuda_ms(kernel), "warm_ms": time_cuda_ms(kernel, cold=False),
            "plain_ms": time_cuda_ms(lambda: logmel._log10_mel_plain(a, n_mels)),
            "library_ms": time_cuda_ms(library),
            "library_warm_ms": time_cuda_ms(library, cold=False),
            "bound_ms": bound, "bound_by": by, "dense_bound_ms": dense,
        }
        print(f"logmel {label:>9s} / {n_mels:3d} mels ({n_frames} frames): kernel_ms "
              f"{row['ms']:.5f} (warm L2 {row['warm_ms']:.5f}) plain_ms {row['plain_ms']:.5f} "
              f"library_ms {row['library_ms']:.5f} (warm L2 {row['library_warm_ms']:.5f}) "
              f"bound_ms {bound:.5f} ({by}; FFT {flops / 1e6:.2f} MFLOP) "
              f"dense_dft_bound_ms {dense:.5f} max_err {err:.3g}")
    silence = logmel.log_mel_spectrogram(torch.zeros(SR, device="cuda"), 80).cpu().numpy()
    if not np.allclose(silence, silence.flat[0]):
        raise AssertionError("silence does not give a constant floor")
    print(f"logmel: all {len(rows)} cases within tolerance of the plain version and the f64 "
          f"oracle; silence is a constant floor")
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


def run_policy_last(asr, audio: np.ndarray, guard: FailOnLog, pipeline) -> dict:
    """The stream of the golden pipelined rows (tools/golden.py): 1 s
    chunks, trimming at 15 s, prefix policy "last", ``pipeline`` False,
    True (exact) or "async". Returns the committed words (times rounded to
    the ms, as the rows store them), each process_iter call's host ms and
    each applied tick's dispatch-to-apply ms (``last_apply_latency_s``)."""
    from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor

    proc = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0), prefix_policy="last",
                              pipeline=pipeline)
    calls, applies = [], []
    apply = proc.apply_result

    def timed_apply(res, proc_delay_s=0.0, time_offset=None):
        out = apply(res, proc_delay_s, time_offset)
        applies.append(1e3 * proc.last_apply_latency_s)
        return out

    proc.apply_result = timed_apply
    for pos in range(0, len(audio), SR):
        proc.insert_audio_chunk(audio[pos : pos + SR])
        t0 = time.perf_counter()
        proc.process_iter()
        calls.append(1e3 * (time.perf_counter() - t0))
    proc.finish()
    if guard.records:
        raise AssertionError(f"streaming loop swallowed an exception: {guard.records}")
    return {"commits": [[round(float(b), 3), round(float(e), 3), w] for b, e, w in proc.commited],
            "calls": calls, "applies": applies}


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
    rows = recorded["matrix"]
    for i in range(3):
        audio = golden_audio(i)
        got = {mode: run_policy_last(asr, audio, guard, mode)["commits"]
               for mode in (False, True, "async")}
        for mode, want in ((False, rows["pipeline_async"]["sync_commits"][i]),
                           (True, rows["pipeline_exact"]["commits"][i]),
                           ("async", rows["pipeline_async"]["commits"][i])):
            if got[mode] != want:
                raise AssertionError(f"golden pipelined clip {i}, pipeline={mode!r}: commits "
                                     f"{got[mode]} != recorded {want}")
        if got[True] != got[False]:
            raise AssertionError(f"golden pipelined clip {i}: exact commits differ from sync")
    print("golden f32 pipelined rows: the sync, exact and async commits of 3 clips under prefix "
          "policy \"last\" equal pipeline_async.sync_commits, pipeline_exact.commits and "
          "pipeline_async.commits; exact equals sync")


def phase_full_width(guard: FailOnLog, quantization: str | None = None) -> dict:
    """The main path at full width, large-v3 with seeded random weights in
    bf16 (quantized at load for a tier). Returns the launch counts of the
    counted run."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul, logmel
    from realtime_whisper_asr_tpu_torch.utils.profiling import PhaseTimer, measure_sync_floor

    label = f"large-v3 {quantization or 'bf16'}"
    t0 = time.perf_counter()
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization=quantization)
    asr.transcribe_kargs["max_total_tokens"] = 32  # random weights never emit EOT
    loop = asr.decode_loop
    torch.cuda.synchronize()
    print(f"{label}: random init in {time.perf_counter() - t0:.1f} s")
    results = []
    transcribe = asr.transcribe

    def recording_transcribe(*args, **kwargs):
        results.append(transcribe(*args, **kwargs))
        return results[-1]

    asr.transcribe = recording_transcribe
    # rows of every K2 call site: per encoded window the cross-K/V linears
    # (B x audio_ctx rows), per prefill span the six block linears (B x
    # tokens rows). The loop's steps (B = 1 row each) are counted by the
    # DecodeLoop: its warm-up steps run, a capture records launches and runs
    # none, and each replay runs K steps
    rows = {"windows": [], "spans": []}
    for name, key in (("precompute_cross_kv", "windows"), ("decode_span", "spans")):
        inner = getattr(asr.model, name)

        def counted(first, *args, _inner=inner, _key=key, **kwargs):
            rows[_key].append(first.shape[0] * first.shape[1] if _key == "windows"
                              else first.numel())
            return _inner(first, *args, **kwargs)

        setattr(asr.model, name, counted)
    offline_audio = np.concatenate([golden_audio(i) for i in range(2)])  # 16 s
    stream_audio = golden_audio(2)  # 8 s
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, with the launch counts read around it
    with TickProbe(asr) as probe:
        logmel.logmel_launches = 0
        int4_matmul.int4_launches = 0
        rows["windows"].clear()
        rows["spans"].clear()
        stats0 = dict(loop.stats)
        t0 = time.perf_counter()
        asr.transcribe(offline_audio)
        torch.cuda.synchronize()
        offline_s = time.perf_counter() - t0
        tick_ms: list[float] = []
        run_stream(asr, stream_audio, guard, tick_ms)
        steps = (loop.stats["warmup_steps"] - stats0["warmup_steps"]
                 + loop.k * (loop.stats["replays"] - stats0["replays"]))
        launches = {"logmel": logmel.logmel_launches, "int4": int4_matmul.int4_launches,
                    "passes": len(rows["spans"]) + steps}
    # ----
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}

    ticks = 1 + len(stream_audio) // SR
    if asr.counters["ticks"] != ticks or len(results) != ticks:
        raise AssertionError(f"{asr.counters['ticks']} ticks and {len(results)} results, "
                             f"expected {ticks}")
    if launches["logmel"] != asr.counters["ticks"]:
        raise AssertionError(f"logmel launched {launches['logmel']} times for {ticks} "
                             f"encoded windows")
    if graphs["replays"] == 0 or graphs["eager_steps"] != 0:
        raise AssertionError(f"the decode loop did not run as CUDA graphs: {graphs}")
    probe.check(label)
    if all(w["captured"] for w in probe.windows):
        raise AssertionError(f"every window captured a graph; no replay-only window: "
                             f"{probe.windows}")
    if len(rows["windows"]) != ticks:
        raise AssertionError(f"{len(rows['windows'])} encoded windows, expected {ticks}")
    int4 = quantization in ("int4", "int4-all")
    predicted, formula = check_k2_launches(label, asr, rows, graphs, launches["int4"], int4)
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
            return D.greedy_decode(asr.model, xa, opts, plan, aux, asr._extra_suppress,
                                   loop=loop)

        decode()  # the 16 s window's graph is captured already; this replays it
        decode_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = decode()
            decode_s.append(time.perf_counter() - t0)
        decode_s = float(np.median(decode_s))
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
                print(f"{label}: {name} device time not measured (no kernels traced)")
                continue
            busy[name] = sum(e.self_device_time_total for e in events) / 1e3
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
            print(f"{label}: {name} device time {busy[name]:.2f} ms, top kernels: "
                  + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                              for e in top))
    n_tokens = int(res.lengths[0]) - int(res.tokens[0][res.lengths[0] - 1] == asr.cfg.eot)
    p50, p95 = np.percentile(tick_ms, [50, 95])
    print(f"{label}: offline 16 s transcribe {offline_s:.2f} s (first call, graphs captured "
          f"in it), {len(results[0].tokens)} tokens; stream of {ticks - 1} ticks, tick p50 "
          f"{p50:.1f} ms p95 {p95:.1f} ms; logmel launches {launches['logmel']} = encoded "
          f"windows; K2 launches {launches['int4']} (predicted {predicted}"
          + (f" = {formula})" if int4 else ")"))
    share = {k: f"{v / wall:.0%}" if k in busy else "not measured"
             for k, v, wall in (("encode", busy.get("encode", 0), encode_ms),
                                ("decode", busy.get("decode", 0), 1e3 * decode_s))}
    dev_tok = (f"{busy['decode'] / n_tokens:.2f} ms" if "decode" in busy else "not measured")
    print(f"{label}: encode_ms (16 s bucket, log-mel + encoder, host clock to "
          f"sync, median of 5) {encode_ms:.2f} (card busy {share['encode']}); "
          f"decode {1e3 * decode_s / n_tokens:.2f} ms per sampled token on the host clock "
          f"(median of 3 windows), {dev_tok} of kernels per token, over {n_tokens} "
          f"(prefill included; card busy {share['decode']}); "
          f"max_memory_allocated {peak_gib:.2f} GiB")
    eager = EAGER_LOOP[quantization]
    print(f"{label}: the eager loop (PERF.md section 5) for comparison: tick p50 "
          f"{eager['tick_p50_ms']} ms, decode {eager['host_ms_per_token']} ms per token on "
          f"the host clock, {eager['kernel_ms_per_token']} ms of kernels, card busy "
          f"{eager['busy']}")
    print(f"{label}: decode loop as CUDA graphs of K = {loop.k} steps: {graphs['captures']} "
          f"captures in {graphs['capture_s']:.2f} s, graph pool "
          f"{loop.stats['graph_bytes'] / 2**20:.1f} MiB, state buffers "
          f"{graphs['state_bytes'] / 2**20:.1f} MiB, {graphs['replays']} replays, "
          f"{graphs['warmup_steps']} warm-up steps, {graphs['checks']} host checks; host syncs "
          f"per window (dispatch + finalize waits / allowed, * = captured in it): "
          + probe.syncs())

    # the stream again, every loop shape it meets captured already
    warm_ms: list[float] = []
    captures = loop.stats["captures"]
    run_stream(asr, stream_audio, guard, warm_ms)
    p50, p95 = np.percentile(warm_ms, [50, 95])
    print(f"{label}: the stream again with its graphs captured "
          f"({loop.stats['captures'] - captures} new captures): tick p50 {p50:.1f} ms p95 "
          f"{p95:.1f} ms")
    # a tick's phases: the stream once more, the timer syncing at each boundary
    asr.phase_timer = PhaseTimer()
    run_stream(asr, stream_audio, guard)
    report = asr.phase_timer.report()
    asr.phase_timer = None
    n = report["decode"]["count"]
    print(f"{label}: PhaseTimer split of a tick (mean ms over {n} ticks; sync floor "
          f"{measure_sync_floor():.3f} ms): "
          + ", ".join(f"{k} {v['mean_ms']}" for k, v in report.items()))
    check_graph_equals_uncaptured(asr, label, offline_audio, stream_audio)
    phase_pipelined(asr, guard, label, rows, int4)
    return launches


def check_k2_launches(label: str, asr, rows: dict, graphs: dict, launched: int,
                      int4: bool) -> tuple[int, str]:
    """K2's launches in a run against the count the model's structure
    predicts from the run's encoded windows, prefill spans (``rows``) and
    loop steps (``graphs``: warm-up steps, and K per replay); for the int4
    tiers, every K2 code path the run took must be among those the K2
    phases hold bit for bit. -> (predicted, how)."""
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul

    # K2 serves every int4 product: per encoded window the cross key and
    # value of each decoder layer, per decoder pass each layer's fused qkv,
    # self out, cross query, cross out, fc1 and fc2 (the head is int8); an
    # int4_linear is one launch at M <= DECODE_MAX_M rows and two above
    def per_linear(m: int) -> int:
        return 1 if m <= int4_matmul.DECODE_MAX_M else 2

    k = asr.decode_loop.k
    passes = rows["spans"] + [1] * (graphs["warmup_steps"] + k * graphs["replays"])
    win = sum(per_linear(m) for m in rows["windows"])
    dec = sum(per_linear(m) for m in passes)
    predicted = asr.cfg.n_text_layer * (2 * win + 6 * dec) if int4 else 0
    small = sum(m <= int4_matmul.DECODE_MAX_M for m in passes)
    formula = (f"{asr.cfg.n_text_layer} layers x (2 x {len(rows['windows'])} windows x 2 "
               f"launches + 6 x ({small} passes of <= {int4_matmul.DECODE_MAX_M} rows x 1 + "
               f"{len(passes) - small} passes x 2)); the passes are {len(rows['spans'])} "
               f"prefill spans, {graphs['warmup_steps']} warm-up steps and "
               f"{graphs['replays']} replays x {k} steps")
    if win != 2 * len(rows["windows"]):
        raise AssertionError(f"an encoded window of <= {int4_matmul.DECODE_MAX_M} rows: "
                             f"{rows['windows']}")
    if launched != predicted:
        raise AssertionError(f"{label}: K2 launched {launched} times, predicted {predicted} "
                             f"({formula})")
    if int4:  # every K2 path this run took is held against its plain version
        used = {k2_path(m) for m in rows["windows"] + passes}
        held = {k2_path(m) for _, m, kk, _ in INT4_SHAPES if kk >= asr.cfg.n_text_state}
        if used - held:
            raise AssertionError(f"K2 paths {sorted(used - held)} ran at large-v3 widths but no "
                                 f"row of INT4_SHAPES holds them against the plain version")
        spans = sorted(set(rows["spans"]))
        unheld = sorted(set(spans) - {m for _, m, _, _ in INT4_SHAPES})
        print(f"{label}: K2 paths taken {sorted(used)} (rows of the prefill spans: {spans}"
              + (f"; spans whose row count no K2 shape holds itself: {unheld}" if unheld else "")
              + "), each path held bit for bit in the K2 phases")
    return predicted, formula


#: rounds of the bf16 pipelined phase: each round streams synchronously,
#: exact and async, in an order that turns from round to round, so the
#: modes' host-clock times are compared in turns within one call
PIPELINE_ROUNDS = 3


def phase_pipelined(asr, guard: FailOnLog, label: str, rows: dict, int4: bool) -> None:
    """Pipelined ticks at full width on phase 5's ASR and graphs: the 8 s
    stream under prefix policy "last", synchronously, exact and async in
    ``PIPELINE_ROUNDS`` rounds (bf16), or async once (int4); each stream a
    run of its own with the launch counts set to 0 just before it and read
    just after: K1 launched once a window, K2 (int4) as predicted, with the
    16-slot prefill spans the device drafts add. Exact must commit the
    synchronous stream's words bit for bit in every round, and every async
    run the same words; host syncs per window as in phase 5
    (``TickProbe``). Prints each run, then each mode's figures pooled over
    its runs: process_iter p50/p95, dispatch-to-apply p50, the ASR's
    dispatch and finalize host ms, the finalize's wait."""
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul, logmel

    loop = asr.decode_loop
    audio = golden_audio(2)
    modes = [("sync", False), ("exact", True), ("async", "async")]
    order = ([[("async", "async")]] if int4 else
             [modes[r % 3:] + modes[: r % 3] for r in range(PIPELINE_ROUNDS)])
    pooled: dict[str, dict[str, list]] = {}
    commits: dict[str, list] = {}
    for r, runs in enumerate(order):
        for name, mode in runs:
            stats0 = dict(loop.stats)
            rows["windows"].clear()
            rows["spans"].clear()
            # ---- this stream's run, with the launch counts read around it
            logmel.logmel_launches = 0
            int4_matmul.int4_launches = 0
            with TickProbe(asr) as probe:
                run = run_policy_last(asr, audio, guard, mode)
            launched = {"logmel": logmel.logmel_launches, "int4": int4_matmul.int4_launches}
            # ----
            graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}
            what = f"{label} pipelined {name} (round {r + 1})"
            probe.check(what)
            windows = len(probe.windows)
            if launched["logmel"] != windows or windows != len(rows["windows"]):
                raise AssertionError(f"{what}: logmel launched {launched['logmel']} times, "
                                     f"{windows} windows decoded, {len(rows['windows'])} "
                                     f"encoded")
            predicted, formula = check_k2_launches(what, asr, rows, graphs, launched["int4"],
                                                   int4)
            forced = [-int(aux[0, D.AUX_TOK + 5]) for aux in probe.draft_aux]
            if mode == "async" and not forced:
                raise AssertionError(f"{what}: no tick was dispatched with a device draft")
            first = commits.setdefault(name, run["commits"])
            if run["commits"] != first:
                raise AssertionError(f"{what}: commits {run['commits']} differ from the first "
                                     f"{name} run's {first}")
            pool = pooled.setdefault(name, {"calls": [], "applies": [], "dispatch": [],
                                            "finalize": [], "wait": []})
            for key, values in (("calls", run["calls"]), ("applies", run["applies"]),
                                ("dispatch", probe.half_ms["dispatch"]),
                                ("finalize", probe.half_ms["finalize"]),
                                ("wait", probe.wait_ms)):
                pool[key].extend(values)
            calls = np.percentile(run["calls"], [50, 95])
            print(f"{what}: process_iter p50 {calls[0]:.1f} ms p95 {calls[1]:.1f} ms, "
                  f"dispatch-to-apply p50 {np.median(run['applies']):.1f} ms; "
                  f"{graphs['replays']} replays of {loop.k} steps; prefill spans of "
                  f"{sorted(set(rows['spans']))} rows; "
                  f"{graphs['captures']} captures ({len(loop._graphs)} loop shapes kept of "
                  f"{D.MAX_GRAPHS}); device drafts forcing {forced} tokens; logmel launches "
                  f"{launched['logmel']} = windows; K2 launches {launched['int4']} (predicted "
                  f"{predicted}" + (f" = {formula})" if int4 else ")")
                  + f"; {len(run['commits'])} words committed; host syncs per window "
                  f"(dispatch + finalize waits / allowed, * = captured in it): {probe.syncs()}")
            if r and graphs["captures"]:
                print(f"{what}: captures recur after the first round ({graphs['captures']}): "
                      f"more loop shapes are live than the {len(loop._graphs)} kept")
    if not int4 and commits["exact"] != commits["sync"]:
        raise AssertionError(f"{label}: exact commits {commits['exact']} != sync commits "
                             f"{commits['sync']}")
    for name, pool in pooled.items():
        pct = {k: np.percentile(v, [50, 95]) for k, v in pool.items()}
        print(f"{label} pipelined {name}, {len(pool['applies'])} ticks over "
              f"{len(pool['applies']) // (len(audio) // SR)} runs: process_iter p50 "
              f"{pct['calls'][0]:.1f} ms p95 {pct['calls'][1]:.1f} ms; dispatch-to-apply "
              f"(last_apply_latency_s) p50 {pct['applies'][0]:.1f} ms p95 "
              f"{pct['applies'][1]:.1f} ms; ASR dispatch p50 {pct['dispatch'][0]:.2f} ms, "
              f"finalize p50 {pct['finalize'][0]:.2f} ms (its wait for the result copy p50 "
              f"{pct['wait'][0]:.3f} ms, max {max(pool['wait']):.3f} ms)")
    if not int4:
        print(f"{label} pipelined: in each of {PIPELINE_ROUNDS} rounds exact committed the "
              f"synchronous stream's words bit for bit ({len(commits['sync'])} words); every "
              f"async run committed the same {len(commits['async'])} words")


def check_graph_equals_uncaptured(asr, label: str, *clips: np.ndarray) -> None:
    """The graph path's packed result against the same step function run
    uncaptured on the card (``DecodeLoop`` at the same K, no capture), bit
    for bit, for each clip's window, once more with a host draft (the first
    4 sampled tokens forced, the next 8 drafted), and once with a forced
    device draft (``decode.patch_aux_device_draft`` from the first packed
    result, still on the card, at offset 1 with a safety tail of 2: its
    tokens must come back verbatim). On a difference, prints the first
    divergent token and the top-2 logit margin of the uncaptured path
    there, and fails."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    cfg = asr.cfg
    opts = asr._make_opts()
    done = []
    for audio in clips:
        with torch.inference_mode():
            xa = asr._logmel_encode(torch.from_numpy(asr._pad_window(audio)).cuda())
        plan0 = D.plan_window(cfg, opts)
        for variant in ("no draft", "host draft", "forced device draft"):
            if variant == "no draft":
                plan = plan0
            elif variant == "host draft":
                ids = [int(t) for t in first.cpu()[: plan0.max_new]]
                plan = D.plan_window(cfg, opts, None, ids[:4], ids[4:12])
            else:
                plan = D.plan_window(cfg, opts, force_draft_bucket=True)
            aux = torch.from_numpy(plan.aux).cuda()[None]
            if variant == "forced device draft":
                D.patch_aux_device_draft(aux, first, 1, plan0.max_new, first.numel(), cfg.eot,
                                         force=True, safety=2)
            graph_dev, eager_packed = (
                D._decode_window(asr.model, opts, xa, aux, plan, asr._extra_suppress, None,
                                 loop, captured=captured)
                for loop, captured in ((asr.decode_loop, True),
                                       (D.DecodeLoop(k=asr.decode_loop.k), False)))
            graph_packed, eager_packed = graph_dev.cpu(), eager_packed.cpu()
            if variant == "no draft":
                first = graph_dev
            if variant == "forced device draft":
                n = -int(aux[0, D.AUX_TOK + 5])
                forced = graph_packed[:n].long().tolist()
                if n <= 0 or forced != first.cpu()[1 : 1 + n].long().tolist():
                    raise AssertionError(f"{label}: forced device draft of {n} tokens, decoded "
                                         f"{forced}, not the first result's tokens 1..{n}")
                variant += f" of {n} tokens"
            what = (f"{label} {xa.shape[1] // 50} s window, p={len(plan.init)}, draft_max="
                    f"{plan.draft_max}, {variant}")
            if torch.equal(graph_packed.view(torch.int32), eager_packed.view(torch.int32)):
                done.append(what)
                continue
            tok_g, tok_e = graph_packed[: plan.max_new], eager_packed[: plan.max_new]
            diff = (tok_g != tok_e).nonzero()
            if not len(diff):
                raise AssertionError(f"{what}: graph and uncaptured tokens equal, the rest of "
                                     f"the packed result differs by up to "
                                     f"{float((graph_packed - eager_packed).abs().max()):.3g}")
            i = int(diff[0])
            hist = np.concatenate([plan.init, tok_e[:i].numpy().astype(np.int64)])
            with torch.inference_mode():
                logits, _ = asr.model.decode_span(torch.from_numpy(hist)[None].cuda(), 0,
                                                  asr.model.init_cache(xa, text_ctx=448))
            top2 = torch.topk(logits[0, -1].float(), 2).values
            raise AssertionError(f"{what}: graph path differs from the uncaptured loop at "
                                 f"sampled token {i} ({int(tok_g[i])} vs {int(tok_e[i])}), "
                                 f"top-2 logit margin {float(top2[0] - top2[1]):.4g}")
    print(f"{label}: graph path bit-equal to the uncaptured loop on the card: "
          + "; ".join(done))


def _bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


#: K2 shapes (name, M, K, N): large-v3's decode step (M = 1: fused qkv, self
#: and cross wo, fc1, fc2); its prefill spans, short (the start-of-transcript
#: prompt, M = 2 to 8: each of the decode kernel's row counts) and long
#: (M = 24, above 8 rows: the tensor-core product, fc2 over all 40 groups;
#: M = 32 and 48: the 16-slot draft spans after prompts of 16 and 32);
#: the cross-K/V projection at the 16 s bucket; and test-tiny's (one scale
#: group at K = 64; the fused-qkv N = 192; two groups). Every path the
#: large-v3 int4 run takes is among them (phase_full_width checks it).
INT4_SHAPES = (
    ("decode qkv", 1, 1280, 3840),
    ("decode wo", 1, 1280, 1280),
    ("decode fc1", 1, 1280, 5120),
    ("decode fc2", 1, 5120, 1280),
    ("span wo M=2", 2, 1280, 1280),
    ("sot qkv M=4", 4, 1280, 3840),
    ("sot fc1 M=4", 4, 1280, 5120),
    ("sot fc2 M=4", 4, 5120, 1280),
    ("span fc2 M=8", 8, 5120, 1280),
    ("prefill qkv M=24", 24, 1280, 3840),
    ("prefill fc1 M=24", 24, 1280, 5120),
    ("prefill fc2 M=24", 24, 5120, 1280),
    ("draft span fc1 M=32", 32, 1280, 5120),
    ("draft span fc2 M=48", 48, 5120, 1280),
    ("cross-K/V 16 s", 800, 1280, 1280),
    ("test-tiny qkv G=1", 1, 64, 192),
    ("test-tiny prefill G=1", 17, 64, 192),
    ("test-tiny fc2 G=2", 5, 256, 64),
)


def k2_path(m: int) -> str:
    """The K2 code path a product of m rows takes: the decode kernel at its
    row count (1, 2, 4 or 8), or the tensor-core product above 8 rows."""
    from realtime_whisper_asr_tpu_torch.ops.int4_matmul import DECODE_MAX_M

    if m > DECODE_MAX_M:
        return "tensor-core"
    return f"decode rows<={next(t for t in (1, 2, 4, 8) if m <= t)}"


def _int4_case(rng, m: int, k: int, n: int):
    """Seeded weight quantized by the port's int4 quantizer: (wp, s), and the
    dequantized (N, K) weight in bf16 that the library yardstick multiplies."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q

    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)).cuda()
    wp, s = Q.quantize_int4(w)
    return wp, s, Q.dequant(wp, s).to(torch.bfloat16)


def _k2_row(name: str, got, ref, kernel, plain, library, nbytes: float, m: int, k: int,
            n: int) -> dict:
    """Checks a K2 output bit for bit against its plain version and times the
    three calls."""
    import torch

    torch.cuda.synchronize()
    if got.shape != (m, n) or got.dtype != ref.dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K2 {name}: output {tuple(got.shape)} {got.dtype} not finite / "
                             f"wrong shape")
    err = float((got.float() - ref.float()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"K2 {name}: kernel != plain version, max |Δ| {err:.3g}")
    bound, by = _bound(nbytes, 2 * m * k * n, PEAK_INT8_OPS)
    return {"max_abs_err": err, "bound_ms": bound, "bound_by": by,
            "ms": time_cuda_ms(kernel), "plain_ms": time_cuda_ms(plain),
            "library_ms": time_cuda_ms(library)}


def phase_int4() -> dict:
    """K2's ``int4_matmul`` (int8 in, f32 out) against its plain version at
    every shape: both are exact (integer sums, then the same rounded f32
    operations in the same order), so they must be equal bit for bit."""
    import torch

    from realtime_whisper_asr_tpu_torch.ops import int4_matmul as K2

    rng = np.random.default_rng(4)
    rows = {}
    for name, m, k, n in INT4_SHAPES:
        wp, s, wd = _int4_case(rng, m, k, n)
        wd = wd.t().contiguous()  # (K, N): x @ W, the bf16 tier's product
        xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).cuda()
        a = xq.to(torch.bfloat16)
        g = s.shape[0]
        row = rows[name] = _k2_row(
            f"int4_matmul {name}", K2.int4_matmul(xq, wp, s), K2.int4_matmul_plain(xq, wp, s),
            lambda: K2._int4_matmul_kernel(xq, wp, s), lambda: K2.int4_matmul_plain(xq, wp, s),
            lambda: torch.matmul(a, wd),  # the bf16 tier's product
            k // 2 * n + 4 * g * n + m * k + 4 * m * n, m, k, n)
        print(f"int4_matmul {name:22s} M={m:4d} K={k:5d} N={n:5d} G={g:2d}: kernel_ms "
              f"{row['ms']:.5f} plain_ms {row['plain_ms']:.5f} library_ms (bf16 matmul, "
              f"dequantized weight) {row['library_ms']:.5f} bound_ms {row['bound_ms']:.5f} "
              f"({row['bound_by']}) max_err {row['max_abs_err']:.3g}")
    print(f"int4_matmul: kernel equals its plain version bit for bit at all {len(rows)} shapes")
    return rows


def phase_int4_linear() -> dict:
    """K2's ``int4_linear`` (the whole int4 linear: row quantization,
    product, ``* sx``, cast, bias) against ``int4_linear_plain`` at every
    shape, x in bf16 and f32, with and without bias: equal bit for bit.
    Library: ``F.linear`` of bf16 x with the dequantized bf16 weight (and
    bias), the bf16 tier's call. Keys (shape name, dtype, bias)."""
    import torch
    import torch.nn.functional as F

    from realtime_whisper_asr_tpu_torch.ops import int4_matmul as K2

    rng = np.random.default_rng(6)
    rows = {}
    for name, m, k, n in INT4_SHAPES:
        wp, s, wd = _int4_case(rng, m, k, n)
        x32 = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).cuda()
        b32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        g = s.shape[0]
        for dtype in (torch.bfloat16, torch.float32):
            x, xb = x32.to(dtype), x32.to(torch.bfloat16)
            for bias in (None, b32.to(dtype)):
                bb = None if bias is None else bias.to(torch.bfloat16)
                size = x.element_size()
                row = _k2_row(
                    f"int4_linear {name} {dtype} bias={bias is not None}",
                    K2.int4_linear(x, wp, s, bias), K2.int4_linear_plain(x, wp, s, bias),
                    lambda: K2._int4_linear_kernel(x, wp, s, bias),
                    lambda: K2.int4_linear_plain(x, wp, s, bias),
                    lambda: F.linear(xb, wd, bb),
                    size * m * k + k // 2 * n + 4 * g * n + size * (m * n + (bias is not None) * n),
                    m, k, n)
                key = (name, "bf16" if dtype == torch.bfloat16 else "f32", bias is not None)
                rows[key] = row
                print(f"int4_linear {name:22s} M={m:4d} K={k:5d} N={n:5d} {key[1]:4s} "
                      f"bias={int(key[2])}: kernel_ms {row['ms']:.5f} plain_ms "
                      f"{row['plain_ms']:.5f} library_ms (bf16 F.linear, dequantized weight) "
                      f"{row['library_ms']:.5f} bound_ms {row['bound_ms']:.5f} "
                      f"({row['bound_by']})")
    print(f"int4_linear: kernel equals its plain version bit for bit at all {len(rows)} cases")
    return rows


def phase_int4_linear_kernels() -> dict:
    """The CUDA kernels one large-v3 ``Int4Linear`` forward launches (bf16,
    1280 -> 1280 with bias: the cross value projection), counted by the
    profiler at M = 1 and M = 800 after a warm-up call; more than 2 fails.
    Also the host's time to issue one forward at M = 1 (mean over 300 calls,
    the card left to drain afterwards) beside a bf16 ``nn.Linear`` of the same
    shape: the decode loop is host-bound, so this is the linear's cost there."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
    from realtime_whisper_asr_tpu_torch.models.whisper.model import Int4Linear

    rng = np.random.default_rng(7)
    lin = Int4Linear(1280, 1280, dtype=torch.bfloat16, device="cuda")
    w = torch.from_numpy((rng.standard_normal((1280, 1280)) / 36).astype(np.float32)).cuda()
    q, s = Q.quantize_int4(w)
    lin.load_state_dict({"q": q, "s": s, "bias": torch.zeros(1280, dtype=torch.bfloat16)})
    counts = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for m in (1, 800):
        x = torch.from_numpy(rng.standard_normal((1, m, 1280)).astype(np.float32))
        x = x.cuda().bfloat16()
        with torch.inference_mode():
            lin(x)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                lin(x)
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages()  # kernels, copies and sets on the card
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        n = counts[m] = sum(e.count for e in events)
        print(f"Int4Linear forward, large-v3 1280 -> 1280 bf16, M = {m}: {n} device "
              f"operation(s) traced: " + "; ".join(f"{e.key[:48]} x{e.count}" for e in events))
        if not 1 <= n <= 2:
            raise AssertionError(f"Int4Linear at M = {m} launched {n} device operations "
                                 f"(allowed 1-2; 0 means the profiler saw none)")
    dense = torch.nn.Linear(1280, 1280, dtype=torch.bfloat16, device="cuda")
    x = torch.from_numpy(rng.standard_normal((1, 1, 1280)).astype(np.float32)).cuda().bfloat16()
    host_us = {}
    with torch.inference_mode():
        for name, mod in (("Int4Linear", lin), ("bf16 nn.Linear", dense)):
            for _ in range(20):
                mod(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(300):
                mod(x)
            host_us[name] = (time.perf_counter() - t0) / 300 * 1e6
            torch.cuda.synchronize()
    print("host time to issue one forward at M = 1 (mean of 300): " +
          ", ".join(f"{k} {v:.1f} us" for k, v in host_us.items()))
    return counts


def phase_chain() -> dict:
    """K3 against its plain version at the microbenchmark's shapes.

    Tolerance: both accumulate each product in f32 and round it to bf16,
    with the f32 terms summed in another order. Two orders of a D-term f32
    sum differ by at most 2·D·2^-24·Σ|terms|, and the bf16 rounding adds at
    most one bf16 ulp, so at k = 1 each element is within
    ulp(plain) + 2·D·2^-24·(|x| @ |W|) of the plain value. Along a chain a
    flipped rounding feeds every element of the next product, which flips
    more roundings: after a few products the two chains carry independent
    bf16 rounding noise of the same size, and no elementwise bound between
    them holds. So for k > 1 each is held against the exact chain (f32
    products, no intermediate rounding): the kernel's rms and max error must
    be within 1.25x of the plain version's, i.e. the kernel adds no error of
    its own beyond bf16 rounding."""
    import torch

    from realtime_whisper_asr_tpu_torch.ops import matmul_chain as K3

    t, d = 800, 1280
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32))
    w = w.cuda().bfloat16()
    rows = {}
    for k in (1, 8, 32):
        ws = torch.stack([w] * k).contiguous()  # the tool's chain: one weight k times
        before = K3.chain_launches
        got = K3.matmul_chain(x, ws)
        if K3.chain_launches - before != 1:
            raise AssertionError(f"K3 k={k}: {K3.chain_launches - before} launches for one chain")
        ref = K3.matmul_chain_plain(x, ws)
        exact = x.float()
        for _ in range(k):
            exact = exact @ w.float()
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        if k == 1:
            ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=1e-30))) - 7)
            tol = ulp + 2 * d * 2.0 ** -24 * (x.float().abs() @ w.float().abs())
            if bool((diff > tol).any()):
                raise AssertionError(f"K3 k=1: {int((diff > tol).sum())} elements beyond one "
                                     f"bf16 ulp plus the f32 order bound of the plain version")
        e_k, e_p = got.float() - exact, ref.float() - exact
        rms_k, rms_p = float(e_k.square().mean().sqrt()), float(e_p.square().mean().sqrt())
        max_k, max_p = float(e_k.abs().max()), float(e_p.abs().max())
        if k > 1 and (rms_k > 1.25 * rms_p or max_k > 1.25 * max_p):
            raise AssertionError(f"K3 k={k}: error against the exact chain rms {rms_k:.3g} "
                                 f"max {max_k:.3g}, plain's rms {rms_p:.3g} max {max_p:.3g}")

        def library():  # yardstick only: k cuBLAS bf16 matmuls, never called by the port
            h = x
            for wk in ws:
                h = torch.matmul(h, wk)
            return h

        bound, by = _bound(2 * k * d * d + 2 * 2 * t * d, 2 * t * d * d * k, PEAK_BF16_FLOPS)
        row = {
            "max_abs_err": float(diff.max()), "bound_ms": bound, "bound_by": by,
            "ms": time_cuda_ms(lambda: K3._matmul_chain_kernel(x, ws)),
            "plain_ms": time_cuda_ms(lambda: K3.matmul_chain_plain(x, ws)),
            "library_ms": time_cuda_ms(library),
        }
        rows[k] = row
        print(f"chain k={k:2d} T={t} D={d}: kernel_ms {row['ms']:.5f} "
              f"({row['ms'] / k * 1e3:.2f} us/product) plain_ms {row['plain_ms']:.5f} "
              f"library_ms {row['library_ms']:.5f} ({row['library_ms'] / k * 1e3:.2f} "
              f"us/product) bound_ms {bound:.5f} ({by}) max |kernel - plain| "
              f"{row['max_abs_err']:.3g}; vs the exact chain: kernel rms {rms_k:.3g} max "
              f"{max_k:.3g}, plain rms {rms_p:.3g} max {max_p:.3g} (|exact| max "
              f"{float(exact.abs().max()):.3g})")
    print("chain: kernel within tolerance of its plain version at k = 1, 8, 32; one launch "
          "per chain")
    return rows


def phase_microbench() -> int:
    """The port's encoder microbenchmark, K3's path: its fused-chain and
    encoder sections (the latter at reduced reps), with K3's launches
    counted around them."""
    from realtime_whisper_asr_tpu_torch.ops import matmul_chain
    from realtime_whisper_asr_tpu_torch.tools import microbench_encoder as MB

    results: dict = {}
    _, x, w = MB._inputs()
    # ---- K3's path, with its launch count read around it
    matmul_chain.chain_launches = 0
    MB.section_fused_chain(x, w, results)
    MB.section_encoder(results, reps=3)
    launches = matmul_chain.chain_launches
    # ----
    print(f"microbench_encoder (K3 launched {launches} times): " + json.dumps(results))
    if launches == 0:
        raise AssertionError("microbench: K3 was never launched")
    for key in ("encoder_bf16_ms", "encoder_int8_ms", "fused_chain_k32_us"):
        if not np.isfinite(results[key]) or results[key] <= 0:
            raise AssertionError(f"microbench {key} = {results[key]}")
    return launches


def _forced_logits(asr, audio: np.ndarray, tokens: list[int]) -> np.ndarray:
    """f32 logits predicting each of ``tokens`` after the window's initial
    tokens, teacher-forced in one decode_span on ``asr``'s device."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    plan = D.plan_window(asr.cfg, asr._make_opts())
    audio_dev, _ = asr._upload(audio, plan.aux)
    p = len(plan.init)
    with torch.inference_mode():
        xa = asr._logmel_encode(audio_dev)
        seq = torch.from_numpy(np.concatenate([plan.init, tokens]).astype(np.int64))
        logits, _ = asr.model.decode_span(seq[None].to(xa.device), 0,
                                          asr.model.init_cache(xa, text_ctx=128))
    return logits[0, p - 1 : p - 1 + len(tokens)].float().cpu().numpy()


def phase_golden_quant() -> list[str]:
    """The golden matrix rows of the quantized tiers at f32 on the card.

    A quantized path rounds x/sx to int8, so an activation within an f32 ulp
    of a .5 tie rounds by the last bit of the f32 arithmetic before it, which
    the card and the CPUs that recorded the rows compute in other orders. A
    row that differs is diagnosed: teacher-forced along the recorded tokens,
    the card's logits are compared with the port's on the CPU (which
    reproduces every row exactly, tests/test_torch_quant.py). The divergence
    counts as a near-tie flip only if the CPU's margin between the recorded
    token and the card's choice at the first divergent step is within the
    card-vs-CPU logit difference already seen on the steps before it; it is
    printed and returned, and anything else fails."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul as K2

    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        matrix = json.load(f)["matrix"]
    state = load_flat_npz(os.path.join(GOLDEN, "params.npz"))
    audio = golden_audio(0)
    flips = []
    for tier, key in (("int8-all", "int8all"), ("int4", "int4")):
        asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cuda",
                              params=state, quantization=tier)
        asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
        before = K2.int4_launches
        res = asr.transcribe(audio)
        launched = K2.int4_launches - before
        if tier == "int4" and launched == 0:
            raise AssertionError("golden int4: K2 was never launched")
        row = {"tokens": [int(t) for t in res.tokens],
               "text": "".join(seg.text for seg in res).strip()}
        note = f" (K2 launched {launched} times)" if tier == "int4" else ""
        if row == matrix[key]:
            print(f"golden {key} at f32: tokens and text equal the recorded row{note}")
            continue
        rec, got = matrix[key]["tokens"], row["tokens"]
        i = next(j for j in range(min(len(rec), len(got)) + 1)
                 if j == min(len(rec), len(got)) or rec[j] != got[j])
        if i >= min(len(rec), len(got)) or i == 0:
            raise AssertionError(f"golden {key}: {row} != recorded {matrix[key]}")
        cpu = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                              params=state, quantization=tier)
        card_l = _forced_logits(asr, audio, rec[: i + 1])
        cpu_l = _forced_logits(cpu, audio, rec[: i + 1])
        margin = float(cpu_l[i, rec[i]] - cpu_l[i, got[i]])
        noise = float(np.abs(card_l[:i] - cpu_l[:i]).max())
        at_flip = float(np.abs(card_l[i] - cpu_l[i]).max())
        msg = (f"golden {key} at f32: NEAR-TIE FLIP at token {i} of {len(rec)} (recorded "
               f"{rec[i]}, card {got[i]}): CPU margin {margin:.4g}; card-vs-CPU max |Δlogit| "
               f"{noise:.4g} over the {i} agreeing steps, {at_flip:.4g} at the flip; "
               f"logit scale {float(np.abs(cpu_l).max()):.4g}; tokens before it equal{note}")
        print(msg)
        if not 0 <= margin <= noise:
            raise AssertionError(f"golden {key}: {row} != recorded {matrix[key]}, and the "
                                 f"divergence is no near-tie ({msg})")
        flips.append(msg)
    return flips


def main() -> int:
    import gc

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
    logmel_rows = phase_logmel()
    int4_rows = phase_int4()
    linear_rows = phase_int4_linear()
    phase_int4_linear_kernels()
    chain_rows = phase_chain()
    phase_golden(guard)
    near_ties = phase_golden_quant()  # printed again at the end
    launches = {}
    for tier in (None, "int4"):
        launches[tier] = phase_full_width(guard, tier)
        gc.collect()
        torch.cuda.empty_cache()
    chain_launches = phase_microbench()
    src = "realtime_whisper_asr_tpu_torch/csrc/"
    entries = []
    for name, source, replaces, count, rows, main_row in (
        ("logmel", src + "logmel.cu", "realtime_whisper_asr_tpu/ops/logmel.py:76",
         launches[None]["logmel"], logmel_rows, ("16 s", 128)),  # the offline clip's bucket
        # the main path calls int4_linear (bf16, with bias): its row stands for
        # K2; the error is the largest over int4_matmul's and int4_linear's rows
        ("int4_linear", src + "int4_matmul.cu", "realtime_whisper_asr_tpu/ops/int4_matmul.py:44",
         launches["int4"]["int4"], {**int4_rows, **linear_rows}, ("decode fc1", "bf16", True)),
        ("matmul_chain", src + "matmul_chain.cu", "tools/microbench_encoder.py:127",
         chain_launches, chain_rows, 32),
    ):
        row = rows[main_row]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for msg in near_ties:
        print(msg)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
