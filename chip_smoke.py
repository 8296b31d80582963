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
     in two rounds taken in turns, with K1 launched in each stream; exact
     must commit the synchronous stream's words bit for bit and every async
     run the same words, no exception swallowed; per mode process_iter
     p50/p95, the dispatch-to-apply latency, dispatch and finalize host ms
     and the finalize's wait, captures and the host syncs of each window as
     above;
  6. the packed-int4 kernel family (K2) against its plain versions, bit for
     bit, at the large-v3 decode shapes (M = 1), its prefill spans (M = 2,
     4, 8 and 24), the 16 s cross-K/V shape (M = 800), the serving phase's
     batched spans and cross-K/V (M = 64, 1152, 3200) and the test-tiny
     shapes, with times: ``int4_matmul`` (int8 in, f32 out) and
     ``int4_linear`` (x in bf16 and f32, with and without bias); then a
     profiler count of the kernels one large-v3 ``Int4Linear``
     forward launches at M = 1 and M = 800 (at most 2);
  7. golden parity of the quantized tiers at f32: ``int8-all`` and ``int4``
     on the golden weights reproduce the recorded matrix rows, and the
     ``prequant`` row: the ``int8-all`` model saved in the port's native
     format and reloaded as a pre-quantized artifact;
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
     port's encoder microbenchmark section (bf16 and int8-all encoder);
 10. VAC: the golden ``vac`` row at f32 on the card (the Silero-like VAD on
     the card too), synchronously and with ``pipeline=True``; the device
     audio ring's grow -> shift -> full on the card, each ring the s16 audio
     and zero past it, each window ``ring[:bucket]`` bit-equal to the padded
     whole-window upload; the Silero-like VAD on the card against its CPU
     run (probabilities within 1e-4, the same events, the smallest margin to
     a threshold, host us a chunk); each pipelined run of phase 5 prints its
     upload plans and h2d bytes a window (``UploadProbe``);
 11. the headline (``phase_headline``): bench.py's headline loop through the
     port, large-v3 ``int8-all``, async, VAC with EnergyVAD, 96-token caps,
     4 tokens a second: the graph path bit-equal to the uncaptured loop at
     this tier, a warm-up pass and 2 runs of 16 s with K1's launches equal to
     the windows encoded and no logged error; median RTF, apply latency
     p50/p95, plan kinds, h2d bytes a window, captures, a PhaseTimer split;
 12. batched multi-stream serving (``phase_serving``): the port's
     StreamServer on the golden f32 weights commits on the card what it
     commits on the CPU (3 streams, batched and pipelined), and
     ``greedy_decode_batch`` equals each row's own decode; at large-v3
     ``int8-all`` a batch of 4 rows at different states is bit-equal through
     the graph path and the uncaptured loop; bench.py's ``BENCH_STREAMS``
     loop (no VAD, policy "last", 96-token caps, 16 s a stream in 1 s
     chunks, a warm-up pass, then a timed one) at N = 8 and N = 1:
     aggregate RTF, ticks, new tokens, no group failure, batch sizes,
     dispatch ms, captures, K1 launches = rows encoded, peak memory per row
     beside ``_hbm_safe_batch``'s estimate, the decode's kernel split at
     B = 8 and 1; the ``int8-kv`` tier at N = 8 (RTF, its step's kernel
     split beside ``int8-all``'s); for both tiers the measured growth a row
     at most ``serving._row_bytes`` and the allocator's fragmentation and
     the memory outside it within the cap's constants; the int4 tier at
     N = 8 over 8 s with K2's launches equal to the prediction and every K2
     path held in phase 6;
 13. checkpoints (``phase_checkpoint``): a seeded large-v3 written as an HF
     directory in bf16 by the port's writer and loaded bit for bit through
     ``TorchWhisperASR(checkpoint_dir=)``, alignment heads included;
     converted by the port's ``tools/convert_checkpoint.py`` to ``int8-all``
     and ``int4`` artifacts, each token-identical to quantizing at load
     (K2's launches as predicted for int4); ``int8-kv`` from the same
     directory, its graph path bit-equal to the uncaptured loop at the 16 s
     and 30 s windows;
 14. beam search and sampling (``phase_beam``): large-v3 beam 5 over a 16 s
     window at bf16 and at ``int8-kv``, the graph path bit-equal to the
     uncaptured loop (tokens, score, no-speech probability, capture), host
     ms a token and kernel ms a beam step beside greedy's B = 1 step; the
     retry ladder with all five rungs on one captured loop shape and the
     seed advanced by 5; the sampler's bits and Gumbel values on the card
     against the CPU's; ``detect_language``; ``decode_full``'s logits
     against ``decode_span``'s; ``int4`` beam 5 with K2's launches as
     predicted (5 rows a step); beam 5 through ``StreamServer`` at
     ``int8-all``, N = 4 streams of 8 s (aggregate RTF, the growth a stream
     under ``_row_bytes`` for 5 beams). Phase 4 adds, on the golden weights:
     the ``beam5`` row, batched beam equal to per-row beam, the ladder's
     tokens and ``detect_language`` equal to the port's on the CPU, and
     ``decode_full`` within 1e-4 of ``decode_span``.
 15. the application path: ``phase_separation`` holds the separation
     (``separate_vocals`` and ``separate_stems_device``, three variants at
     the 8, 16 and 30 s buckets), the band-pass, the phase vocoder with its
     carried phase and the dedup features on the card against the CPU with
     TF32 off, and times the separation a window beside its bound;
     ``phase_app_golden`` runs the golden f32 weights through the port's
     StreamingApp on the card and the CPU in bench.py's scenarios 2-5 at
     test-tiny (5: the neural separator fused into the encode) and a time
     stretch / adaptive decode / diarization case (lines, labels, stats
     equal; a near-tie flip diagnosed), then ``StreamServer(diarize=True,
     separator=<trained net>)`` on 2 golden streams, card == CPU;
     ``phase_app`` is bench.py's scenario 5 at full width (large-v3
     ``int8-all``, the fused separator, the Silero-like VAD on the card,
     music-backed speech, a warm-up and a timed 16 s pass): RTF, results
     and skips, K1 launches = windows encoded, no capture, the separation's
     device ms a window beside the encode's, the frontend's peak memory a
     row beside ``_row_bytes``' reserve for it, a PhaseTimer split.
 16. the command line and training: ``phase_cli`` runs the port's CLI as a
     user does: ``detect`` names the card and recommends from its memory,
     ``transcribe`` of golden clip 0 on the golden weights (a native
     checkpoint) prints the golden row's text and its ``--output-format
     srt`` bytes equal the ``--cpu`` run's, ``stream --wav`` runs one
     session (K1's launches counted); ``phase_train`` holds the optimizer on
     the card against the CPU bit for bit, runs three
     ``tools/finetune.py`` steps of the golden test-tiny weights on the card
     against the same three on the CPU (losses within 1e-4 relative,
     parameters within 1e-6 but for at most 4 elements), holds the batch's
     K1 mel against the plain version on the card, checks a save, load and
     continue on the card bit-equal to the uninterrupted run, then the
     full-width cell: large-v3 f32 from seed 0, 2 rows x 16 s x 64 tokens,
     the finetune recipe, a warm-up and 3 timed steps on one batch (loss per
     step, seconds a step, tokens a second, hand-counted FLOPs over the f32
     peak, peak memory beside the prediction, K1 = 2 launches a step) and a
     profiled step's split (log-mel / forward + backward / optimizer, GEMM
     share, busy share); ``phase_train_vad`` runs ``tools/train_vad.py``'s
     loop: its first step on the card against the CPU's, then 20 steps
     whose loss falls.
 17. the parallel path (``phase_parallel``), one card as a world of one over
     NCCL (mesh 1 x 1, one pipeline stage), every collective run at size 1:
     the large-v3 ``int8-all`` checkpoint read by ``load_checkpoint_sharded``
     bit-equal to ``load_checkpoint``; its ``shard_model`` decode of a 16 s
     window (32-token cap, the collectives captured in the loop's graphs)
     with prefill logits and packed result bit-equal to the unsharded
     model's, kernel ms a step beside it; the full-width training cell's two
     steps through ``make_sharded_train_step``, plain and
     sequence-parallel, bit-equal to ``make_train_step``'s in both losses and
     every tensor (seconds a step, peak memory), one 1-stage 2-microbatch
     ``make_pp_train_step`` step's loss within 1e-5 relative; the sharded
     test-tiny train state's resume bit-equal; ``tools/finetune.py --mesh
     1x1`` under ``torch.distributed.run --nproc-per-node 1`` exiting 0
     with a checkpoint.
 18. the offline tools and the examples (``phase_tools``): the speaker
     trainer's first step on the card against the CPU's, then 100 steps
     whose loss falls (ms a step with and without the host's minibatch);
     the separator trainer at its defaults (v2, batch 8 x 16,384 samples):
     the first step from one JAX-layout checkpoint on the card against the
     CPU's (loss and every parameter), 20 steps whose loss falls, the
     device step's and the host batch's ms, the step's peak memory, one
     ``v2x4`` step card vs CPU; ``calibrate --synth`` card == CPU; the
     checkpoint drill on the golden weights (every step ok, tokens card ==
     CPU); the soak at large-v3 ``int8-all`` (3 simulated minutes) and at
     its default (test-tiny, 10), both ok, K1's launches = windows encoded;
     ``examples/offline_transcribe.py`` prints golden clip 0's text.
Prints each phase's seconds, one ``{"kernels": [...]}`` line, then as the
last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when CUDA
is absent. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def synthetic_speech(seconds: float, seed: int = 0) -> np.ndarray:
    """bench.py's headline audio (bench.py:48-55)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.61 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    env = 0.55 * (1 + np.sin(2 * np.pi * 2.7 * t))  # syllable-ish AM
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


def golden_vac_audio() -> np.ndarray:
    """The golden VAC clip (tools/golden.py:113-123): two synthetic
    utterances separated by silence, built with the port's synth_speech."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import synth_speech

    rng = np.random.default_rng(2024)
    a, _ = synth_speech(rng, 3.0)
    b, _ = synth_speech(rng, 3.0)
    gap = np.zeros(int(1.2 * SR), np.float32)
    lead = np.zeros(int(0.4 * SR), np.float32)
    return np.concatenate([lead, a, gap, b, gap]).astype(np.float32)


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


def sync_device(device) -> None:
    """Wait for ``device`` (a no-op on the CPU, where the phases rehearse)."""
    from realtime_whisper_asr_tpu_torch.utils.profiling import sync_device as sync

    sync(torch_device(device))


def empty_device_cache(device) -> None:
    """Return the card's cached blocks to it (a no-op on the CPU)."""
    import torch

    if torch_device(device).type == "cuda":
        torch.cuda.empty_cache()


def torch_device(device):
    import torch

    return torch.device(device)


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


class UploadProbe:
    """While installed, counts the ASR's upload plans by kind (a grow that
    carries no words, its buffer already resident, as "resident"), the
    windows it encodes, and the bytes the whole-window upload that the ring
    replaced would have sent for them (each window's bucket as s16 words,
    and the aux bundle). After the block, ``h2d`` holds the change of the
    ASR's copy counters over it."""

    def __init__(self, asr):
        self.asr = asr
        self.kinds: dict[str, int] = {}
        self.windows = 0
        self.window_bytes = 0

    def __enter__(self):
        from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

        asr = self.asr
        plan_upload, encode = asr._plan_upload, asr._encode_from_buf
        self._before = dict(asr.counters)

        def counted_plan(key, audio):
            plan = plan_upload(key, audio)
            kind = "resident" if plan["kind"] == "grow" and not plan["n_new"] else plan["kind"]
            self.kinds[kind] = self.kinds.get(kind, 0) + 1
            return plan

        def counted_encode(n_samples):
            self.windows += 1
            self.window_bytes += 2 * asr._window_bucket(n_samples) + 4 * D.AUX_LEN
            return encode(n_samples)

        asr._plan_upload, asr._encode_from_buf = counted_plan, counted_encode
        return self

    def __exit__(self, *exc):
        del self.asr._plan_upload, self.asr._encode_from_buf
        self.h2d = {k: self.asr.counters[k] - self._before[k]
                    for k in ("h2d_transfers", "h2d_bytes")}

    def summary(self) -> str:
        w = max(self.windows, 1)
        return (f"plans {dict(sorted(self.kinds.items()))}; {self.h2d['h2d_transfers']} "
                f"h2d copies, h2d_bytes per window {self.h2d['h2d_bytes'] / w:.0f} (the "
                f"whole-window upload: {self.window_bytes / w:.0f})")


def phase_card() -> tuple[str, str]:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    # cuBLAS f32 stays IEEE (PyTorch's default, set here for the plain
    # log-mel oracle); cuDNN keeps its TF32 default, as a user's process
    # would: the model's conv stem turns TF32 off for itself
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (default; the port's "
          f"conv stem runs without it) cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} card(s): {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0), smi


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


def phase_golden(guard: FailOnLog):
    """The golden f32 rows on the card -> the test-tiny ASR that ran them."""
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
    check_golden_beam(asr, guard)
    return asr


def run_vac(asr, vad, guard: FailOnLog, pipeline=False) -> tuple[list[str], list]:
    """The golden VAC drive (tools/golden.py:177-203): 0.5 s chunks through
    ``VADIterator(vad)`` and ``OnlineASRProcessor`` trimming at 15 s ->
    (returned texts, every committed word across the utterances, times
    rounded to the ms)."""
    from realtime_whisper_asr_tpu_torch.streaming import (
        OnlineASRProcessor,
        VACOnlineASRProcessor,
        VADIterator,
    )

    online = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0), pipeline=pipeline)
    words = []
    init = online.init

    def keeping_init(offset=None):  # an utterance start wipes ``commited``
        words.extend(online.commited)
        init(offset)

    online.init = keeping_init
    vac = VACOnlineASRProcessor(
        online, VADIterator(vad, threshold=0.5, min_silence_duration_ms=500, speech_pad_ms=100),
        online_chunk_size=0.5)
    audio = golden_vac_audio()
    pieces = []
    for pos in range(0, len(audio), SR // 2):
        vac.insert_audio_chunk(audio[pos : pos + SR // 2])
        pieces.append(vac.process_iter()[2])
    pieces.append(vac.finish()[2])
    words.extend(online.commited)
    if guard.records:
        raise AssertionError(f"VAC loop swallowed an exception: {guard.records}")
    return ([p for p in pieces if p],
            [[round(float(b), 3), round(float(e), 3), w] for b, e, w in words])


def phase_golden_vac(asr, guard: FailOnLog) -> None:
    """The golden ``vac`` row at f32 on the card, the Silero-like VAD on the
    card too: text and commit count equal the recorded row, synchronously
    and under ``pipeline=True`` (whose committed words equal the
    synchronous stream's)."""
    from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD

    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        row = json.load(f)["matrix"]["vac"]
    runs = {mode: run_vac(asr, SileroLikeVAD(device="cuda"), guard, mode)
            for mode in (False, True)}
    for mode, (pieces, _) in runs.items():
        got = {"text": asr.sep.join(pieces).strip(), "commits": len(pieces)}
        if got != row:
            raise AssertionError(f"golden vac, pipeline={mode}: {got} != recorded {row}")
    if runs[True][1] != runs[False][1]:
        raise AssertionError(f"golden vac: exact committed {runs[True][1]}, sync "
                             f"{runs[False][1]}")
    print(f"golden vac at f32 (Silero-like VAD on the card): text and {row['commits']} commits "
          f"equal the recorded row, synchronously and with pipeline=True (the same "
          f"{len(runs[False][1])} words)")


def phase_ring(asr) -> None:
    """tests/test_decode.py:582's grow -> shift -> full sequence on the card:
    after each copy the ring equals the s16-quantized audio and is zero past
    it, and its first window bucket equals, bit for bit, the padded window
    the whole-window upload sent."""
    import torch

    from realtime_whisper_asr_tpu_torch import asr as A
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    rng = np.random.default_rng(7)
    a, b, c, d = ((rng.standard_normal(n) * 0.2).astype(np.float32)
                  for n in (16000, 8000, 4000, 12000))
    ab = np.concatenate([a, b])
    steps = (("full", a), ("grow", ab), ("shift", np.concatenate([ab[6000:], c])), ("full", d))
    key = "chip-smoke-ring"
    aux = np.zeros(D.AUX_LEN, np.float32)
    asr.set_active_stream(key)
    for want, audio in steps:
        kind = asr._plan_upload(key, audio)["kind"]
        aux_dev = asr._sync_audio_and_aux(audio, aux)
        ring = asr._buffers[key][0]
        q = np.clip(np.round(audio * 32768.0), -32768, 32767) / 32768.0
        bucket = asr._window_bucket(len(audio))
        old = A._words_to_samples(torch.from_numpy(A._samples_to_words(
            asr._pad_window(audio))).cuda())
        if (kind != want or ring.device.type != asr.device.type or not np.array_equal(
                ring[: len(audio)].cpu().numpy(), q.astype(np.float32))
                or bool(ring[len(audio):].any()) or not torch.equal(ring[:bucket], old)
                or not np.array_equal(aux_dev.cpu().numpy(), aux)):
            raise AssertionError(f"ring on the card: a {want} plan ({kind}) of {len(audio)} "
                                 f"samples left another ring or window")
    asr.drop_stream(key)
    asr.set_active_stream(None)
    print(f"ring on the card: {' -> '.join(w for w, _ in steps)}, each ring the s16 audio and "
          f"zero past it, each window ring[:bucket] bit-equal to the padded upload")


def phase_vad() -> None:
    """The Silero-like VAD on the card against ``device="cpu"`` over the
    golden VAC clip in 0.5 s chunks through ``VADIterator``: probabilities
    within 1e-4, the same events. Prints the smallest distance of a
    probability to the thresholds 0.5 and 0.35, and the host us a chunk."""
    from realtime_whisper_asr_tpu_torch.models.vad import SileroLikeVAD
    from realtime_whisper_asr_tpu_torch.streaming import VADIterator

    audio = golden_vac_audio()
    out = {}
    for device in ("cuda", "cpu"):
        vad, probs = SileroLikeVAD(device=device), []

        def recording(frames, _vad=vad, _probs=probs):
            p = _vad(frames)
            _probs.extend(p.tolist())
            return p

        it = VADIterator(recording, threshold=0.5, min_silence_duration_ms=500,
                         speech_pad_ms=100)
        events, chunk_us = [], []
        for pos in range(0, len(audio), SR // 2):
            t0 = time.perf_counter()
            events.extend(it(audio[pos : pos + SR // 2]))
            chunk_us.append(1e6 * (time.perf_counter() - t0))
        out[device] = (np.asarray(probs), events, float(np.median(chunk_us[1:])))
    (p_card, ev_card, us_card), (p_cpu, ev_cpu, us_cpu) = out["cuda"], out["cpu"]
    err = float(np.abs(p_card - p_cpu).max())
    margin = float(np.min(np.minimum(np.abs(p_card - 0.5), np.abs(p_card - 0.35))))
    if p_card.shape != p_cpu.shape or err > 1e-4 or ev_card != ev_cpu or len(ev_card) != 4:
        raise AssertionError(f"VAD on the card: max |p - p_cpu| {err:.3g}, events {ev_card} "
                             f"against the CPU's {ev_cpu}")
    print(f"vad: Silero-like VAD on the card, {len(p_card)} frames of the golden VAC clip: max "
          f"|p_card - p_cpu| {err:.3g} (tolerance 1e-4), events equal {ev_card}; smallest "
          f"margin to 0.5 / 0.35 {margin:.3g}; host us per 0.5 s chunk (median) card "
          f"{us_card:.0f}, CPU {us_cpu:.0f}")


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
    rows = count_k2_rows(asr.model)
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
                      int4: bool, steps: list | None = None) -> tuple[int, str]:
    """K2's launches in a run against the count the model's structure
    predicts from the run's encoded windows, prefill spans (``rows``) and
    loop steps (``graphs``: warm-up steps, and K per replay, each of one
    row, or ``steps``: the rows of each step of a batched run); for the
    int4 tiers, every K2 code path the run took must be among those the K2
    phases hold bit for bit. -> (predicted, how)."""
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul

    # K2 serves every int4 product: per encoded window the cross key and
    # value of each decoder layer, per decoder pass each layer's fused qkv,
    # self out, cross query, cross out, fc1 and fc2 (the head is int8); an
    # int4_linear is one launch at M <= DECODE_MAX_M rows and two above
    def per_linear(m: int) -> int:
        return 1 if m <= int4_matmul.DECODE_MAX_M else 2

    k = asr.decode_loop.k
    if steps is None:
        steps = [1] * (graphs["warmup_steps"] + k * graphs["replays"])
    passes = rows["spans"] + steps
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
#: modes' host-clock times are compared in turns within one call (3 until
#: the checkpoint and int8-kv phases needed the time)
PIPELINE_ROUNDS = 2


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
            with TickProbe(asr) as probe, UploadProbe(asr) as uploads:
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
                  + f"; {len(run['commits'])} words committed; {uploads.summary()}; host "
                  f"syncs per window (dispatch + finalize waits / allowed, * = captured in it): "
                  f"{probe.syncs()}")
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


#: port state-dict names -> HF names (``load.py`` maps them the other way);
#: the fused ``attn.qkv`` splits into q/k/v, its zero key bias dropped
_HF_NAMES = (("encoder.pos_emb", "encoder.embed_positions.weight"),
             ("encoder.ln_post.", "encoder.layer_norm."),
             ("decoder.tok_emb", "decoder.embed_tokens.weight"),
             ("decoder.pos_emb", "decoder.embed_positions.weight"),
             ("decoder.ln.", "decoder.layer_norm."), (".blocks.", ".layers."),
             (".attn_ln.", ".self_attn_layer_norm."), (".attn.out.", ".self_attn.out_proj."),
             (".mlp_ln.", ".final_layer_norm."), (".cross_ln.", ".encoder_attn_layer_norm."),
             (".cross.query.", ".encoder_attn.q_proj."), (".cross.key.", ".encoder_attn.k_proj."),
             (".cross.value.", ".encoder_attn.v_proj."), (".cross.out.", ".encoder_attn.out_proj."))


def hf_state_from_port(state: dict) -> dict:
    """A dense port state dict under HF ``WhisperModel`` names (views of its
    tensors, wherever they lie)."""
    out = {}
    for key, t in state.items():
        if ".attn.qkv." in key:
            head = key.split(".attn.qkv.")[0].replace(".blocks.", ".layers.") + ".self_attn."
            parts = t.chunk(3, dim=0)
            for proj, part in zip("qkv", parts):
                if key.endswith("weight") or proj != "k":
                    out[f"{head}{proj}_proj.{key.rsplit('.', 1)[1]}"] = part
            continue
        for ours, theirs in _HF_NAMES:
            key = key.replace(ours, theirs)
        out[key] = t
    return out


def write_hf_dir(path: str, cfg, state: dict, alignment_heads: list) -> int:
    """An HF-layout checkpoint directory of ``state`` (config.json,
    model.safetensors by the port's writer, generation_config.json with
    ``alignment_heads``) -> the safetensors file's bytes."""
    from realtime_whisper_asr_tpu_torch.models.whisper.safetensors_io import write_safetensors

    os.makedirs(path, exist_ok=True)
    hf_cfg = {"num_mel_bins": cfg.n_mels, "max_source_positions": cfg.n_audio_ctx,
              "d_model": cfg.n_audio_state, "encoder_attention_heads": cfg.n_audio_head,
              "encoder_layers": cfg.n_audio_layer, "vocab_size": cfg.n_vocab,
              "max_target_positions": cfg.n_text_ctx,
              "decoder_attention_heads": cfg.n_text_head, "decoder_layers": cfg.n_text_layer}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"alignment_heads": alignment_heads}, f)
    return write_safetensors(os.path.join(path, "model.safetensors"), hf_state_from_port(state))


def count_k2_rows(model) -> dict:
    """Record the rows of every K2 call site of ``model`` from now on: per
    encoded window the cross-K/V linears (B x audio_ctx rows, ``windows``),
    per prefill span the six block linears (B x tokens rows, ``spans``)."""
    rows = {"windows": [], "spans": []}
    for name, key in (("precompute_cross_kv", "windows"), ("decode_span", "spans")):
        inner = getattr(model, name)

        def counted(first, *args, _inner=inner, _key=key, **kwargs):
            rows[_key].append(first.shape[0] * first.shape[1] if _key == "windows"
                              else first.numel())
            return _inner(first, *args, **kwargs)

        setattr(model, name, counted)
    return rows


def _states_equal(a: dict, b: dict) -> list:
    """The keys where two state dicts differ (bit for bit, any device)."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    return sorted(set(a) ^ set(b)) + [k for k in a if k in b and not torch.equal(
        bits(a[k]), bits(b[k].to(a[k].device)))]


def checkpoint_heads(cfg) -> list:
    """The alignment heads written into the checkpoint's generation_config.json."""
    last, half, h = cfg.n_text_layer - 1, cfg.n_text_layer // 2, cfg.n_text_head
    return [[half, 0], [last, 1], [last, h - 1]]


def phase_checkpoint(guard: FailOnLog, model_size: str = "large-v3",
                     device: str = "cuda") -> dict:
    """Checkpoint loading and pre-quantized artifacts at full width, then
    ``int8-kv`` on the checkpoint's model:

    1. a seeded random-weight model (seed 0) written as an HF directory in
       bf16 by the port's own safetensors writer, with alignment heads in
       its generation_config.json; loaded through
       ``TorchWhisperASR(checkpoint_dir=)``: every leaf bit-equal to the
       seeded state, the alignment mask the file's;
    2. converted by the port's ``tools/convert_checkpoint.py`` to native
       ``int8-all`` and ``int4`` artifacts, each reloaded and held
       token-identical (16 s clip, 32-token cap) to the model quantized at
       load from the HF directory, their weights bit-equal, with K1's and
       K2's launches counted around each run (K2 as ``check_k2_launches``
       predicts for int4, 0 for int8-all);
    3. ``int8-kv`` quantized at load from the HF directory: the graph path
       bit-equal to the uncaptured loop at the 16 s and 30 s windows (the
       30 s bucket's value product is the one split in chunks).
    Prints the bytes and the seconds of each write, load and conversion.
    Fails, with the numbers, when the temporary directory has too little
    room. -> {"logmel": ..., "int4": ...} launches of the int4 artifact's run."""
    import gc
    import shutil
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.model import init_params
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul, logmel
    from realtime_whisper_asr_tpu_torch.tools.convert_checkpoint import convert

    cfg = get_config(model_size)
    label = f"checkpoint {model_size}"
    n_params = None
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_params(cfg, gen, torch.bfloat16, device)
        state = model.state_dict()
        n_params = sum(t.numel() for t in state.values())
        # bf16 HF directory + int8-all artifact (~half) + int4 artifact (~half)
        need = int(2 * n_params * 2.2)
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise AssertionError(f"{label}: {free / 2**30:.2f} GiB free under {tmp}, the phase "
                                 f"writes ~{need / 2**30:.2f} GiB")
        hf = os.path.join(tmp, "hf")
        t0 = time.perf_counter()
        heads = checkpoint_heads(cfg)
        hf_bytes = write_hf_dir(hf, cfg, state, heads)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        asr = TorchWhisperASR(checkpoint_dir=hf, dtype=torch.bfloat16, device=device)
        sync_device(device)
        load_s = time.perf_counter() - t0
        bad = _states_equal(state, asr.model.state_dict())
        mask = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
        for layer, head in heads:
            mask[layer, head] = 1.0
        if bad or not np.array_equal(asr.alignment_heads, mask):
            raise AssertionError(f"{label}: the HF directory loaded with leaves {bad[:8]} off "
                                 f"the seeded state, or alignment heads "
                                 f"{np.argwhere(asr.alignment_heads)} != {heads}")
        print(f"{label}: {n_params} parameters written as an HF directory in bf16 by the "
              f"port's writer, {hf_bytes} bytes in {write_s:.2f} s; loaded through "
              f"TorchWhisperASR(checkpoint_dir=) in {load_s:.2f} s, every leaf bit-equal to the "
              f"seeded state ({len(state)} leaves), alignment heads {heads} as the file's")
        # the weight quantizers divide by a tensor: the card's q and s equal the CPU's
        from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q

        for name in ("decoder.blocks.0.fc1.weight", "encoder.blocks.0.attn.qkv.weight"):
            for fn in (Q.quantize_int8, Q.quantize_int4):
                card, cpu = fn(state[name]), fn(state[name].cpu())
                if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
                    raise AssertionError(f"{label}: {fn.__name__}({name}) on {device} differs "
                                         f"from the CPU's")
        print(f"{label}: quantize_int8 and quantize_int4 on {device} bit-equal to the CPU's "
              f"(2 weights)")
        del asr, model, state
        gc.collect()
        empty_device_cache(device)
        audio = np.concatenate([golden_audio(i) for i in range(2)])  # 16 s
        for tier in ("int8-all", "int4"):
            dst = os.path.join(tmp, tier)
            t0 = time.perf_counter()
            _, detected, nbytes = convert(hf, dst, tier, "bfloat16", device)
            convert_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            artifact = TorchWhisperASR(checkpoint_dir=dst, dtype=torch.bfloat16, device=device)
            sync_device(device)
            reload_s = time.perf_counter() - t0
            at_load = TorchWhisperASR(checkpoint_dir=hf, dtype=torch.bfloat16, device=device,
                                      quantization=tier)
            bad = _states_equal(at_load.model.state_dict(), artifact.model.state_dict())
            if detected != tier or artifact.quantization != tier or bad:
                raise AssertionError(f"{label} {tier}: artifact detected {detected}, runs "
                                     f"{artifact.quantization}, leaves off the at-load "
                                     f"quantization {bad[:8]}")
            tokens, launched = {}, {}
            for name, asr in (("artifact", artifact), ("at load", at_load)):
                asr.transcribe_kargs["max_total_tokens"] = 32  # random weights never emit EOT
                rows = count_k2_rows(asr.model)
                stats0 = dict(asr.decode_loop.stats)
                # ---- this model's run, with the launch counts read around it
                logmel.logmel_launches = 0
                int4_matmul.int4_launches = 0
                res = asr.transcribe(audio)
                launched[name] = {"logmel": logmel.logmel_launches,
                                  "int4": int4_matmul.int4_launches}
                # ----
                graphs = {k: asr.decode_loop.stats[k] - stats0[k] for k in stats0}
                tokens[name] = res.tokens
                if launched[name]["logmel"] != 1:
                    raise AssertionError(f"{label} {tier} {name}: logmel launched "
                                         f"{launched[name]['logmel']} times for 1 window")
                predicted, _ = check_k2_launches(f"{label} {tier} {name}", asr, rows, graphs,
                                                 launched[name]["int4"], tier == "int4")
            if tokens["artifact"] != tokens["at load"] or not tokens["artifact"]:
                raise AssertionError(f"{label} {tier}: artifact tokens {tokens['artifact']} != "
                                     f"quantized at load {tokens['at load']}")
            print(f"{label} {tier}: converted in {convert_s:.2f} s ({nbytes} bytes, detected "
                  f"{detected}), reloaded in {reload_s:.2f} s; 16 s clip: {len(tokens['artifact'])} "
                  f"tokens identical to the model quantized at load, weights bit-equal; K1 "
                  f"launches {launched['artifact']['logmel']}, K2 launches "
                  f"{launched['artifact']['int4']} (predicted {predicted})")
            if tier == "int4":
                out = launched["artifact"]
            del artifact, at_load, asr
            gc.collect()
            empty_device_cache(device)
        kv = TorchWhisperASR(checkpoint_dir=hf, dtype=torch.bfloat16, device=device,
                             quantization="int8-kv")
        kv.transcribe_kargs["max_total_tokens"] = 32
        if not kv.model.kv_quant:
            raise AssertionError(f"{label}: int8-kv model without int8 caches")
        if device == "cuda":
            long_audio = np.concatenate([golden_audio(i) for i in range(4)])  # 30 s window
            check_graph_equals_uncaptured(kv, f"{label} int8-kv", audio, long_audio)
        del kv
        gc.collect()
        empty_device_cache(device)
    return out


#: bench.py's headline loop (bench.py:577-727) runs 3 runs of 24 s; cut to
#: 2 runs of 16 s to keep the script inside 1.5x its earlier length
HEADLINE_SECONDS = 16
HEADLINE_RUNS = 2


def phase_headline(guard: FailOnLog, smi: str) -> int:
    """bench.py's headline loop through the port at full width: large-v3
    with seeded random weights in bf16, ``int8-all``, 96-token caps and 4
    tokens a second; VAC with ``EnergyVAD`` over ``OnlineASRProcessor``
    (trimming at 15 s, prefix policy "last", async pipelining); the first
    24 s of ``synthetic_speech(32.0)`` in 1 s chunks fed back to back. First
    the graph path against the uncaptured loop at this tier, then one
    warm-up pass and ``HEADLINE_RUNS`` measured runs, each ``vac.init()`` to
    ``vac.finish()``, with K1's launches set to 0 just before them and read
    just after (they must equal the windows encoded). Prints the median
    real-time factor (process_iter and finish over the audio's seconds), the
    p50/p95 of ``last_apply_latency_s`` over the ticks that committed text,
    the plan kinds, h2d_bytes per window beside the whole-window upload's,
    the captures after the warm-up, the ASR's dispatch and finalize host ms,
    the new tokens and replays, the loop shapes; then a PhaseTimer split of
    one more pass. -> K1's launches."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.vad import EnergyVAD
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.streaming import (
        OnlineASRProcessor,
        VACOnlineASRProcessor,
        VADIterator,
    )
    from realtime_whisper_asr_tpu_torch.utils.profiling import PhaseTimer

    label = "headline large-v3 int8-all"
    t0 = time.perf_counter()
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int8-all")
    asr.transcribe_kargs["max_new_tokens"] = 96
    asr.transcribe_kargs["max_total_tokens"] = 96
    asr.max_tokens_per_second = 4.0
    torch.cuda.synchronize()
    print(f"{label}: random init and int8 quantization in {time.perf_counter() - t0:.1f} s")
    audio = synthetic_speech(HEADLINE_SECONDS + 8.0)[: HEADLINE_SECONDS * SR]
    check_graph_equals_uncaptured(asr, label, audio[: 16 * SR], audio[: 8 * SR])
    online = OnlineASRProcessor(asr, buffer_trimming=("segment", 15.0), prefix_policy="last",
                                pipeline="async")
    vac = VACOnlineASRProcessor(online, VADIterator(EnergyVAD(), min_silence_duration_ms=500),
                                online_chunk_size=0.5)
    loop = asr.decode_loop
    t0 = time.perf_counter()
    for pos in range(0, len(audio), SR):  # warm-up: the measured audio once
        vac.insert_audio_chunk(audio[pos : pos + SR])
        vac.process_iter()
    vac.finish()
    torch.cuda.synchronize()
    print(f"{label}: warm-up pass in {time.perf_counter() - t0:.1f} s, "
          f"{loop.stats['captures']} captures")
    stats0, counters0 = dict(loop.stats), dict(asr.counters)
    shapes, half_ms = set(), {"dispatch": [], "finalize": []}
    loop_of = loop.loop

    def recording_loop(model, key, *args):
        shapes.add(key)
        return loop_of(model, key, *args)

    def timed(fn, name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            half_ms[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    loop.loop = recording_loop
    asr._transcribe_window_dispatch = timed(asr._transcribe_window_dispatch, "dispatch")
    asr._transcribe_window_finalize = timed(asr._transcribe_window_finalize, "finalize")
    rtfs, latency_ms, ticks = [], [], 0
    # ---- the VAC path, with K1's launch count read around it
    with UploadProbe(asr) as uploads:
        logmel.logmel_launches = 0
        for _ in range(HEADLINE_RUNS):
            vac.init()
            busy = 0.0
            for pos in range(0, len(audio), SR):
                vac.insert_audio_chunk(audio[pos : pos + SR])
                t0 = time.perf_counter()
                _, _, txt = vac.process_iter()
                busy += time.perf_counter() - t0
                ticks += 1
                if txt:
                    latency_ms.append(1e3 * online.last_apply_latency_s)
            t0 = time.perf_counter()
            vac.finish()
            busy += time.perf_counter() - t0
            rtfs.append(busy / HEADLINE_SECONDS)
        launches = logmel.logmel_launches
    # ----
    del loop.loop, asr._transcribe_window_dispatch, asr._transcribe_window_finalize
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}
    if guard.records:
        raise AssertionError(f"{label}: the VAC loop swallowed an exception: {guard.records}")
    if launches == 0 or launches != uploads.windows:
        raise AssertionError(f"{label}: logmel launched {launches} times for {uploads.windows} "
                             f"encoded windows")
    if not latency_ms:
        raise AssertionError(f"{label}: no tick committed text")
    p50, p95 = np.percentile(latency_ms, [50, 95])
    print(f"{label} on {smi}: median RTF {np.median(rtfs):.4f} over {HEADLINE_RUNS} runs of "
          f"{HEADLINE_SECONDS} s (runs {', '.join(f'{r:.4f}' for r in rtfs)}; process_iter "
          f"and finish, chunks back to back)")
    print(f"{label} on {smi}: last_apply_latency_s over the {len(latency_ms)} ticks that "
          f"committed text: p50 {p50:.1f} ms p95 {p95:.1f} ms")
    print(f"{label} on {smi}: {ticks} process_iter calls, {uploads.windows} windows encoded "
          f"= logmel launches {launches}; {uploads.summary()}; "
          f"{graphs['captures']} captures after the warm-up pass")
    finalized = asr.counters["ticks"] - counters0["ticks"]
    new_tokens = asr.counters["new_tokens"] - counters0["new_tokens"]
    # a tick's phases: the stream once more, the timer syncing at each boundary
    asr.phase_timer = PhaseTimer()
    vac.init()
    for pos in range(0, len(audio), SR):
        vac.insert_audio_chunk(audio[pos : pos + SR])
        vac.process_iter()
    vac.finish()
    report = asr.phase_timer.report()
    asr.phase_timer = None
    if guard.records:
        raise AssertionError(f"{label}: the VAC loop swallowed an exception: {guard.records}")
    print(f"{label} on {smi}: PhaseTimer split of a tick, the stream once more (mean ms over "
          f"{report['decode']['count']} ticks): "
          + ", ".join(f"{k} {v['mean_ms']}" for k, v in report.items()))
    print(f"{label} on {smi}: where a run's time goes: ASR dispatch p50 "
          f"{np.median(half_ms['dispatch']):.1f} ms (sum {sum(half_ms['dispatch']) / 1e3:.2f} "
          f"s), finalize p50 {np.median(half_ms['finalize']):.2f} ms; "
          f"{new_tokens / max(finalized, 1):.1f} "
          f"new tokens a window over the {finalized} finalized; {graphs['replays']} replays of {loop.k} steps, {graphs['warmup_steps']} "
          f"warm-up steps, {graphs['captures']} captures in {graphs['capture_s']:.2f} s; "
          f"{len(shapes)} loop shapes used (window, prompt, bound, cache, draft slots: "
          + ", ".join(sorted({f"{k.audio_ctx}/{k.p}/{k.max_new}/{k.cache_len}/{k.draft_max}"
                              for k in shapes}))
          + f"; {D.MAX_GRAPHS} kept)")
    return launches


#: bench.py's BENCH_STREAMS mode (run_multistream, bench.py:393-490) through
#: the port: 16 s a stream (bench.py's default is 24), at N = 8 and N = 1;
#: then the int4 tier once at N = 8 over 8 s
SERVING_SECONDS = 16
SERVING_STREAMS = (8, 1)
SERVING_INT4_SECONDS = 8


def serve_streams(server, sids: list, audios: list) -> dict:
    """bench.py's pass: 1 s of audio to every stream, then ``step()`` until
    the server is idle (every dispatched group finalized), chunk after
    chunk. -> each stream's result texts."""
    out = {sid: [] for sid in sids}
    for pos in range(0, max(len(a) for a in audios), SR):
        for sid, audio in zip(sids, audios):
            server.feed(sid, audio[pos : pos + SR])
        while server.step():
            pass
        for sid in sids:
            out[sid].extend(r.text for r in server.poll(sid))
    return out


def _serve_golden(device: str) -> list:
    """3 streams over the golden clips through the port's StreamServer (the
    golden test-tiny weights at f32 on ``device``; no VAD, prefix policy
    "last", pipelined; a constant clock, so no load shedding) -> each
    stream's commits, its final flush included."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
    from realtime_whisper_asr_tpu_torch.serving import StreamServer

    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device=device,
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    server = StreamServer(asr, use_vad=False, online_chunk_size=0.5, prefix_policy="last",
                          clock=lambda: 0.0)
    sids = [server.create_stream() for _ in range(3)]
    out = serve_streams(server, sids, [golden_audio(i) for i in range(3)])
    for sid in sids:
        out[sid].extend(r.text for r in server.close_stream(sid))
    if server.group_failures:
        raise AssertionError(f"golden serving on {device}: {server.group_failures} group failures")
    return [out[sid] for sid in sids], asr


def _first_divergence(asr, xa_row, init: np.ndarray, ref: list, got: list) -> str:
    """The first token where ``got`` leaves ``ref`` and the top-2 logit
    margin of ``asr``'s model there, teacher-forced along ``ref``."""
    import torch

    i = next((j for j, (a, b) in enumerate(zip(ref, got)) if a != b), min(len(ref), len(got)))
    hist = np.concatenate([init, np.asarray(ref[:i], np.int64)]).astype(np.int64)
    with torch.inference_mode():
        logits, _ = asr.model.decode_span(torch.from_numpy(hist)[None].to(xa_row.device), 0,
                                          asr.model.init_cache(xa_row, text_ctx=448))
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return (f"first divergence at sampled token {i} ({ref[i] if i < len(ref) else 'end'} vs "
            f"{got[i] if i < len(got) else 'end'}), top-2 logit margin "
            f"{float(top2[0] - top2[1]):.4g}")


def check_batch_equals_rows(asr, label: str) -> None:
    """``greedy_decode_batch`` on the card against each row's own
    ``greedy_decode`` of its plan at the group's bucket, tokens equal: the
    golden clips' windows at three streaming states (none, a forced prefix,
    a prompt), then with a draft in every row. A difference fails, with the
    top-2 margin at the first divergent token."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    opts = asr._make_opts()
    xa = torch.cat([asr._logmel_encode(torch.from_numpy(asr._pad_window(golden_audio(i))).cuda())
                    for i in range(3)])
    base = []
    for i in range(3):
        plan = D.plan_window(asr.cfg, opts)
        res = D.greedy_decode(asr.model, xa[i : i + 1], opts, plan,
                              torch.from_numpy(plan.aux).cuda(), asr._extra_suppress,
                              loop=asr.decode_loop)
        base.append(res.tokens[0][: res.lengths[0]].tolist())
    groups = {"states": [{}, {"prefix_tokens": base[1][:6]}, {"prompt_tokens": [41, 42, 43]}],
              "drafts": [{"prefix_tokens": b[:3], "draft_tokens": b[3:3 + 4 * (i + 1)]}
                         for i, b in enumerate(base)]}
    for name, requests in groups.items():
        plan = D.plan_batch_aux(asr.cfg, opts, requests)
        batch = D.greedy_decode_batch(asr.model, xa, opts, requests,
                                      extra_suppress=asr._extra_suppress, loop=asr.decode_loop)
        for i, (res, row) in enumerate(zip(batch, plan.rows)):
            one = D.greedy_decode(asr.model, xa[i : i + 1], opts, row,
                                  torch.from_numpy(row.aux).cuda(), asr._extra_suppress,
                                  loop=asr.decode_loop)
            got, ref = (r.tokens[0][: r.lengths[0]].tolist() for r in (res, one))
            if got != ref:
                n = row.n_prefix
                msg = _first_divergence(asr, xa[i : i + 1], row.init, ref[n:], got[n:])
                raise AssertionError(f"{label} group {name!r} row {i} (p={plan.p}, draft_max="
                                     f"{plan.draft_max}): batched tokens {got} != the row's "
                                     f"own decode {ref}; {msg}")
    print(f"{label}: greedy_decode_batch on the card equals each row's greedy_decode at the "
          f"group's bucket, tokens equal (3 rows at 3 states; 3 rows with drafts, draft_max "
          f"{D.DRAFT_MAX})")


def check_batch_graph_equals_uncaptured(asr, label: str, clips: list) -> None:
    """A batched decode of B = len(clips) rows through the graph path and
    through the same step uncaptured on the card, the packed results bit for
    bit (``check_graph_equals_uncaptured`` with B rows), for two groups:
    rows at different streaming states (none, a forced prefix, a prompt, a
    prefix and a draft; one draft-less row makes the group's draft bucket
    0), then every row with a prefix and a draft of its own length (the
    bucket ``DRAFT_MAX``, acceptance the batch minimum)."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    opts = asr._make_opts()
    with torch.inference_mode():
        xa = torch.cat([asr._logmel_encode(torch.from_numpy(asr._pad_window(c)).cuda())
                        for c in clips])
    plan0 = D.plan_window(asr.cfg, opts)
    base = []
    for i in range(len(clips)):
        res = D.greedy_decode(asr.model, xa[i : i + 1], opts, plan0,
                              torch.from_numpy(plan0.aux).cuda(), asr._extra_suppress,
                              loop=asr.decode_loop)
        base.append(res.tokens[0][: res.lengths[0]].tolist())
    ids = base[1]
    groups = {
        "states": ([{}, {"prefix_tokens": ids[:8]}, {"prompt_tokens": [41, 42, 43]},
                    {"prefix_tokens": ids[:4], "draft_tokens": ids[4:12]}][: len(clips)], 0),
        "drafts": ([{"prefix_tokens": b[:3], "draft_tokens": b[3 : 3 + 4 * (i + 1)]}
                    for i, b in enumerate(base)], D.DRAFT_MAX),
    }
    for name, (requests, draft_max) in groups.items():
        plan = D.plan_batch_aux(asr.cfg, opts, requests)
        what = (f"{label}: batch of {len(clips)}, group {name!r} ({xa.shape[1] // 50} s "
                f"windows, p={plan.p}, max_new={plan.max_new}, draft_max={plan.draft_max})")
        if plan.draft_max != draft_max:
            raise AssertionError(f"{what}: the draft bucket is not {draft_max}")
        aux = torch.from_numpy(plan.aux).cuda()
        graph_packed, eager_packed = (
            D._decode_window(asr.model, opts, xa, aux, plan, asr._extra_suppress, None, loop,
                             captured=captured).cpu()
            for loop, captured in ((asr.decode_loop, True),
                                   (D.DecodeLoop(k=asr.decode_loop.k), False)))
        if not torch.equal(graph_packed.view(torch.int32), eager_packed.view(torch.int32)):
            tok_g = graph_packed.view(len(clips), -1)[:, : plan.max_new]
            tok_e = eager_packed.view(len(clips), -1)[:, : plan.max_new]
            bad = (tok_g != tok_e).nonzero()
            if not len(bad):
                raise AssertionError(f"{what}: graph and uncaptured tokens equal, the rest of "
                                     f"the packed result differs")
            r = int(bad[0, 0])
            row = plan.rows[r]
            msg = _first_divergence(asr, xa[r : r + 1], row.init, tok_e[r].long().tolist(),
                                    tok_g[r].long().tolist())
            raise AssertionError(f"{what}: the graph path differs from the uncaptured loop in "
                                 f"row {r}; {msg}")
        print(f"{what}: graph path bit-equal to the uncaptured loop on the card")


def _memory_row_estimate(asr) -> tuple[int, int]:
    """(``_hbm_safe_batch``'s cost of one row for the model's dtype, cache
    kind and the ASR's beams, the model's parameter and buffer bytes)."""
    import itertools

    from realtime_whisper_asr_tpu_torch.serving import _beam_size, _row_bytes

    model = asr.model
    return (_row_bytes(asr.cfg, model.kv_quant, model.dtype.itemsize, _beam_size(asr)),
            sum(t.numel() * t.element_size()
                for t in itertools.chain(model.parameters(), model.buffers())))


def run_capacity(asr, n: int, seconds: int, label: str, guard: FailOnLog) -> dict:
    """bench.py's run_multistream (bench.py:393-490) at N = ``n`` streams:
    a server with no VAD, 0.5 s online chunks, prefix policy "last" and
    ``max_batch`` max(N, 2); ``synthetic_speech(seconds)`` to every stream, 1
    s at a time, then ``step()`` until idle; a warm-up pass, the processors
    reset and the counters zeroed in place, then the timed pass (and once
    more under a PhaseTimer, for a group's split), with K1's
    launches, the batch sizes, each group's dispatch ms, the rows encoded
    and the loop's captures read around it. The ASR gets a new DecodeLoop,
    and the peak memory over both passes is read against the memory
    allocated before them (the model): what N streams add, their graphs'
    state buffers and pool included."""
    import gc

    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.serving import StreamServer
    from realtime_whisper_asr_tpu_torch.services import PerformanceMonitor
    from realtime_whisper_asr_tpu_torch.utils.profiling import PhaseTimer

    asr.decode_loop = loop = D.DecodeLoop()
    gc.collect()  # the previous loop's graphs and state buffers
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    server = StreamServer(asr, use_vad=False, online_chunk_size=0.5, prefix_policy="last",
                          max_batch=max(n, 2))
    sids = [server.create_stream() for _ in range(n)]
    audio = synthetic_speech(seconds)
    t0 = time.perf_counter()
    serve_streams(server, sids, [audio] * n)  # warm-up: every loop shape of the pass
    warm_s = time.perf_counter() - t0
    for sid in sids:  # reset the streams, keep the graphs
        server.streams[sid].processor.init()
    server.monitor = PerformanceMonitor()
    for key in asr.counters:  # in place: the ASR increments these keys
        asr.counters[key] = 0
    server.group_failures = 0
    sizes, dispatch_ms, encoded = [], [], []
    dispatch, encode = asr.transcribe_batch_dispatch, asr._encode_many

    def timed_dispatch(items):
        t0 = time.perf_counter()
        out = dispatch(items)
        dispatch_ms.append(1e3 * (time.perf_counter() - t0))
        sizes.append(len(items))
        return out

    def counted_encode(keys, n_samples):
        encoded.append(len(keys))
        return encode(keys, n_samples)

    asr.transcribe_batch_dispatch, asr._encode_many = timed_dispatch, counted_encode
    stats0 = dict(loop.stats)
    # ---- the timed pass, with K1's launch count read around it
    logmel.logmel_launches = 0
    t0 = time.perf_counter()
    serve_streams(server, sids, [audio] * n)
    wall = time.perf_counter() - t0
    launches = logmel.logmel_launches
    # ----
    del asr.transcribe_batch_dispatch, asr._encode_many
    peak = torch.cuda.max_memory_allocated()
    # the allocator's fragmentation at the peak, and what lies outside it
    # (the CUDA context, library workspaces): _hbm_safe_batch's constants
    reserved = torch.cuda.max_memory_reserved()
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}
    counters = dict(asr.counters)
    # a group's phases: the pass once more, the timer syncing at each boundary
    for sid in sids:
        server.streams[sid].processor.init()
    asr.phase_timer = PhaseTimer()
    serve_streams(server, sids, [audio] * n)
    split = asr.phase_timer.report()
    asr.phase_timer = None
    if server.group_failures or guard.records:
        raise AssertionError(f"{label} N={n}: {server.group_failures} group failures, logged "
                             f"errors {guard.records}")
    if counters["ticks"] == 0:
        raise AssertionError(f"{label} N={n}: the timed pass decoded no tick")
    if launches != sum(encoded) or not launches:
        raise AssertionError(f"{label} N={n}: logmel launched {launches} times for "
                             f"{sum(encoded)} rows encoded")
    for sid in sids:
        asr.drop_stream(sid)
    return {"n": n, "rtf": wall / (n * seconds), "wall": wall, "warm_s": warm_s,
            "warm_captures": stats0["captures"],
            "ticks": counters["ticks"], "new_tokens": counters["new_tokens"],
            "sizes": sizes, "dispatch_ms": dispatch_ms, "rows": sum(encoded),
            "launches": launches, "graphs": graphs, "peak": peak, "base": base,
            "reserved": reserved, "outside": outside, "total": total,
            "cap": server.device_batch_cap, "shapes": len(loop._graphs), "split": split}


def record_loop_steps(loop) -> list:
    """Wrap ``loop``'s ``loop`` and ``run`` (undo with ``del loop.loop,
    loop.run``) to record the rows of every step it takes from now on: its
    warm-up steps and each replayed or uncaptured step, B rows a step, B·K
    for a beam search of K beams. Returns the list they append to."""
    steps: list[int] = []
    loop_of, run_of = loop.loop, loop.run

    def recording_loop(model, key, *args):
        w0 = loop.stats["warmup_steps"]
        out = loop_of(model, key, *args)
        steps.extend([key.batch * key.beam_size] * (loop.stats["warmup_steps"] - w0))
        return out

    def recording_run(lp, steps_max):
        r0, e0 = loop.stats["replays"], loop.stats["eager_steps"]
        run_of(lp, steps_max)
        n_steps = loop.k * (loop.stats["replays"] - r0) + loop.stats["eager_steps"] - e0
        steps.extend([lp.state.tokens.shape[:-1].numel()] * n_steps)

    loop.loop, loop.run = recording_loop, recording_run
    return steps


def check_row_memory(asr, label: str, smi: str, run: dict, growth: float, how: str) -> None:
    """The measured peak growth a row against ``_row_bytes`` (the repaired
    formula's cost of a row for the model's tier) and ``_hbm_safe_batch``'s
    constants against the card: the allocator's fragmentation at the peak
    (reserved less allocated) within ``HOLD_BACK`` of the card, the memory
    outside the allocator (the CUDA context, library workspaces) within
    ``FIXED_BYTES``. Prints ``device_batch_cap``; fails on a breach."""
    from realtime_whisper_asr_tpu_torch.serving import FIXED_BYTES, HOLD_BACK

    row_est, param_bytes = _memory_row_estimate(asr)
    frag = run["reserved"] - run["peak"]
    print(f"{label} on {smi}: peak memory growth a row ({how}) {growth / 2**20:.1f} MiB against "
          f"_row_bytes {row_est / 2**20:.1f} MiB (2 groups in flight: "
          f"{2 * row_est / 2**20:.1f} MiB); parameters and buffers {param_bytes / 2**30:.2f} GiB; "
          f"fragmentation at the peak {frag / 2**20:.1f} MiB ({frag / run['total']:.2%} of the "
          f"card, HOLD_BACK {HOLD_BACK:.0%}); outside the allocator {run['outside'] / 2**20:.1f} "
          f"MiB (FIXED_BYTES {FIXED_BYTES / 2**30:.0f} GiB); device_batch_cap {run['cap']} on "
          f"{run['total'] / 2**30:.1f} GiB")
    if growth > row_est or frag > HOLD_BACK * run["total"] or run["outside"] > FIXED_BYTES:
        raise AssertionError(f"{label}: the serving cap's formula is breached on the card")


def profile_decode_split(asr, label: str, b: int, replays: int = 2) -> dict:
    """Kernel time of the decode loop's step at batch ``b`` by name: one
    batched decode of ``b`` rows (8 s windows, no prefix, the serving caps)
    captures its graph, then ``replays`` replays of that graph (K steps
    each; past the loop's end a step still runs every kernel and writes
    nothing) are traced: the time a step, the top kernels and the share of
    the dtype copies (the f32 upcasts in ``_attend`` and the head)."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    # a 16-token bound keeps the serving loop's shape where it matters for a
    # step (window, prompt, a 128-position cache) and takes 16 steps, not 96
    opts = dataclasses.replace(asr._make_opts(), max_new_tokens=16, max_total_tokens=16)
    with torch.inference_mode():
        xa = asr._logmel_encode(torch.from_numpy(asr._pad_window(synthetic_speech(8.0))).cuda())
    loop = asr.decode_loop
    D.greedy_decode_batch(asr.model, xa.expand(b, -1, -1).contiguous(), opts, [{}] * b,
                          extra_suppress=asr._extra_suppress, loop=loop)
    key, graph = next(reversed(loop._graphs.items()))  # the loop shape just used
    if key.batch != b:
        raise AssertionError(f"{label}: the last loop shape has batch {key.batch}, not {b}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays):
            graph.run_k()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    steps = replays * loop.k
    if not events:
        print(f"{label}: decode step at B={b}: device time not measured (no kernels traced)")
        return {}
    total = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.self_device_time_total for e in events if "copy" in e.key.lower()) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    print(f"{label}: decode step at B={b} (window {key.audio_ctx // 50} s, p={key.p}, cache "
          f"{key.cache_len}; {steps} steps traced): kernels {total / steps:.3f} ms a step, dtype "
          f"copies {copies / steps:.3f} ms ({copies / total:.0%}); top a step: "
          + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3 / steps:.3f} ms"
                      for e in top))
    return {"per_step": total / steps, "copies": copies / steps}


def phase_serving(guard: FailOnLog, smi: str) -> dict:
    """Batched multi-stream serving through the port's StreamServer:

    1. test-tiny golden weights at f32: 3 streams over the golden clips,
       batched and pipelined, commit on the card what the same server
       commits on the CPU; ``greedy_decode_batch`` on the card equals each
       row's own decode (``check_batch_equals_rows``);
    2. large-v3 ``int8-all`` (seed 0, 96-token caps): a batch of 4 rows at
       different states, then 4 rows each with a draft (the bucket
       ``DRAFT_MAX``), the graph path bit-equal to the uncaptured loop;
    3. capacity, bench.py's ``BENCH_STREAMS`` mode at N = 8 and N = 1
       (``run_capacity``): aggregate RTF = wall / (N x 16 s), ticks, new
       tokens, group failures (must be 0), batch sizes, group dispatch ms
       p50, captures after the warm-up, K1 launches = rows encoded, peak
       memory and its growth per row beside ``_hbm_safe_batch``'s estimate,
       a PhaseTimer split of a group; the decode step's kernel split at
       B = 8 and B = 1;
    4. the int4 tier once at N = 8 over 8 s: K2's launches equal the count
       predicted from the run's cross-K/V calls, prefill spans and loop
       steps (B rows each), every row count it takes a K2 shape of phase 6.
    -> K1's and K2's launches in the int4 pass."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul, logmel
    from realtime_whisper_asr_tpu_torch.serving import StreamServer

    parts: dict[str, float] = {}
    t_part = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 1)
        t_part[0] = now

    # 1. correctness at f32
    cpu, _ = _serve_golden("cpu")
    lap("golden cpu")
    card, golden_asr = _serve_golden("cuda")
    lap("golden card")
    if card != cpu or not all(card):
        raise AssertionError(f"golden serving: the card's commits {card} != the CPU's {cpu}")
    print(f"golden serving f32: 3 streams, batched and pipelined, commit on the card what the "
          f"CPU commits ({[len(c) for c in card]} results a stream)")
    check_batch_equals_rows(golden_asr, "golden f32")
    del golden_asr
    lap("batch vs rows")

    # 2. the graph path at B = 4, large-v3 int8-all
    label = "serving large-v3 int8-all"
    t0 = time.perf_counter()
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int8-all")
    asr.transcribe_kargs.update(max_new_tokens=96, max_total_tokens=96)
    print(f"{label}: random init and int8 quantization in {time.perf_counter() - t0:.1f} s")
    lap("init int8-all")
    check_batch_graph_equals_uncaptured(asr, label, [synthetic_speech(8.0, seed=s)
                                                     for s in range(4)])
    lap("graph check B=4")

    # 3. capacity at N = 8 and N = 1
    runs = {}
    for n in SERVING_STREAMS:
        runs[n] = run = run_capacity(asr, n, SERVING_SECONDS, label, guard)
        lap(f"capacity N={n}")
        print(f"{label} on {smi}: N={n}: aggregate RTF {run['rtf']:.4f} (wall "
              f"{run['wall']:.2f} s / {n} x {SERVING_SECONDS} s; warm-up pass "
              f"{run['warm_s']:.1f} s, {run['warm_captures']} captures in it); {run['ticks']} "
              f"ticks, {run['new_tokens']} new tokens; "
              f"group_failures 0; batch sizes {sorted(set(run['sizes']))} over "
              f"{len(run['sizes'])} groups; group dispatch p50 "
              f"{np.median(run['dispatch_ms']):.1f} ms; {run['graphs']['captures']} captures "
              f"after the warm-up ({run['shapes']} loop shapes kept); {run['graphs']['replays']} "
              f"replays; rows encoded {run['rows']} = K1 launches {run['launches']}; peak "
              f"memory {run['peak'] / 2**30:.2f} GiB, {(run['peak'] - run['base']) / 2**20:.1f} "
              f"MiB above the model's {run['base'] / 2**30:.2f} GiB; device_batch_cap "
              f"{run['cap']}")
        print(f"{label} on {smi}: N={n}: PhaseTimer split of a group, the pass once more (mean "
              f"ms over {run['split']['decode']['count']} groups): "
              + ", ".join(f"{k} {v['mean_ms']}" for k, v in run["split"].items()))
    big, one = runs[SERVING_STREAMS[0]], runs[SERVING_STREAMS[1]]
    growth = ((big["peak"] - big["base"]) - (one["peak"] - one["base"])) / (big["n"] - one["n"])
    check_row_memory(asr, label, smi, big, growth,
                     f"N={big['n']} against N={one['n']}")
    split = {b: profile_decode_split(asr, label, b) for b in (8, 1)}
    lap("decode split")
    if split[8] and split[1]:
        print(f"{label} on {smi}: a decode step at B=8 costs "
              f"{split[8]['per_step'] / split[1]['per_step']:.2f}x a step at B=1 in kernel time")
    del asr
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    # 3b. int8-kv at N = 8 with the same feed
    label = "serving large-v3 int8-kv"
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int8-kv")
    asr.transcribe_kargs.update(max_new_tokens=96, max_total_tokens=96)
    lap("init int8-kv")
    n = SERVING_STREAMS[0]
    run = runs["int8-kv"] = run_capacity(asr, n, SERVING_SECONDS, label, guard)
    lap(f"capacity int8-kv N={n}")
    print(f"{label} on {smi}: N={n}: aggregate RTF {run['rtf']:.4f} (wall {run['wall']:.2f} s; "
          f"warm-up pass {run['warm_s']:.1f} s); {run['ticks']} ticks, {run['new_tokens']} new "
          f"tokens; group_failures 0; batch sizes {sorted(set(run['sizes']))}; group dispatch "
          f"p50 {np.median(run['dispatch_ms']):.1f} ms; {run['graphs']['captures']} captures "
          f"after the warm-up; rows encoded {run['rows']} = K1 launches {run['launches']}; peak "
          f"{(run['peak'] - run['base']) / 2**20:.1f} MiB above the model's "
          f"{run['base'] / 2**30:.2f} GiB; PhaseTimer split of a group: "
          + ", ".join(f"{k} {v['mean_ms']}" for k, v in run["split"].items()))
    # one N: the growth a row bounded by everything above the model over N
    check_row_memory(asr, label, smi, run, (run["peak"] - run["base"]) / n,
                     f"N={n}: all the peak above the model over {n} rows, an upper bound")
    split_kv = {b: profile_decode_split(asr, label, b) for b in (8, 1)}
    lap("decode split int8-kv")
    for b in (8, 1):
        if split[b] and split_kv[b]:
            print(f"{label} on {smi}: decode step at B={b}: int8-kv {split_kv[b]['per_step']:.3f} "
                  f"ms (dtype copies {split_kv[b]['copies'] / split_kv[b]['per_step']:.0%}) "
                  f"beside int8-all {split[b]['per_step']:.3f} ms (dtype copies "
                  f"{split[b]['copies'] / split[b]['per_step']:.0%}) in kernel time")
    del asr
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the int4 tier once at N = 8
    label = "serving large-v3 int4"
    asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int4")
    asr.transcribe_kargs.update(max_new_tokens=96, max_total_tokens=96)
    lap("init int4")
    loop = asr.decode_loop
    rows = count_k2_rows(asr.model)
    steps = record_loop_steps(loop)
    encoded: list[int] = []
    encode = asr._encode_many

    def counted_encode(keys, n_samples):
        encoded.append(len(keys))
        return encode(keys, n_samples)

    asr._encode_many = counted_encode
    n = SERVING_STREAMS[0]
    server = StreamServer(asr, use_vad=False, online_chunk_size=0.5, prefix_policy="last",
                          max_batch=max(n, 2))
    sids = [server.create_stream() for _ in range(n)]
    audio = synthetic_speech(SERVING_INT4_SECONDS)
    stats0 = dict(loop.stats)
    # ---- the int4 pass, with K1's and K2's launch counts read around it
    logmel.logmel_launches = 0
    int4_matmul.int4_launches = 0
    t0 = time.perf_counter()
    serve_streams(server, sids, [audio] * n)
    wall = time.perf_counter() - t0
    launched = {"logmel": logmel.logmel_launches, "int4": int4_matmul.int4_launches}
    # ----
    del loop.loop, loop.run, asr._encode_many
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}
    steps = list(steps)
    if server.group_failures or guard.records:
        raise AssertionError(f"{label}: {server.group_failures} group failures, logged errors "
                             f"{guard.records}")
    if launched["logmel"] != sum(encoded) or not encoded:
        raise AssertionError(f"{label}: logmel launched {launched['logmel']} times for "
                             f"{sum(encoded)} rows encoded")
    predicted, formula = check_k2_launches(label, asr, rows, graphs, launched["int4"], True,
                                           steps=steps)
    held = {m for _, m, _, _ in INT4_SHAPES}
    used = sorted(set(rows["windows"] + rows["spans"] + steps))
    if set(used) - held:
        raise AssertionError(f"{label}: K2 ran at row counts {sorted(set(used) - held)} that no "
                             f"K2 shape of phase 6 holds against the plain version")
    print(f"{label} on {smi}: N={n} over {SERVING_INT4_SECONDS} s (graphs captured in it): "
          f"wall {wall:.2f} s, aggregate RTF {wall / (n * SERVING_INT4_SECONDS):.4f}; "
          f"{asr.counters['ticks']} ticks; K2 launches {launched['int4']} = predicted "
          f"{predicted} ({formula}); K2 row counts taken {used}, each a K2 shape of phase 6 "
          f"(held bit for bit there); K1 launches "
          f"{launched['logmel']} = rows encoded; batch steps of {sorted(set(steps))} rows; "
          f"{graphs['captures']} captures")
    lap("int4 pass")
    print(f"phase_serving seconds: {parts}")
    return {"logmel": launched["logmel"], "int4": launched["int4"],
            "rtf": {k: v["rtf"] for k, v in runs.items()}}


#: phase_beam's cell: beams, and the server's streams of 8 s a stream
BEAM_SIZE = 5
BEAM_STREAMS = 4
BEAM_SECONDS = 8


def graph_step_ms(loop, replays: int = 2):
    """(the loop shape used last, the kernel ms a step of its graph): the
    graph replayed ``replays`` times under ``torch.profiler`` (past the
    loop's end a step still runs every kernel and writes nothing); None for
    the time when no kernel was traced. The trace's processing, not the
    replays, takes the time: 10.3 s for 5 replays at ``int8-kv``."""
    import torch

    key, graph = next(reversed(loop._graphs.items()))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof, torch.inference_mode():
        for _ in range(replays):
            graph.run_k()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return key, None
    return key, sum(e.self_device_time_total for e in events) / 1e3 / (replays * loop.k)


def check_beam_graph_equals_uncaptured(asr, label: str, xa, plan):
    """A beam search's packed result (tokens, score, length, no-speech
    probability, the winner's capture) through the ASR's graph path and
    through the same step run uncaptured on the card, bit for bit. Returns
    the graph path's packed result on the host."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    opts = asr._make_opts()
    aux = torch.from_numpy(plan.aux).cuda()[None]
    graph, plain = (D._decode_window(asr.model, opts, xa, aux, plan, asr._extra_suppress, None,
                                     loop, captured=captured).cpu()
                    for loop, captured in ((asr.decode_loop, True),
                                           (D.DecodeLoop(k=asr.decode_loop.k), False)))
    if not torch.equal(graph.view(torch.int32), plain.view(torch.int32)):
        diff = (graph[: plan.max_new] != plain[: plan.max_new]).nonzero()
        where = (f"first differing token {int(diff[0])}" if len(diff) else
                 f"tokens equal, the rest differs by {float((graph - plain).abs().max()):.3g}")
        raise AssertionError(f"{label}: the beam graph path differs from the uncaptured loop: "
                             f"{where}")
    print(f"{label}: beam {opts.beam_size} graph path bit-equal to the uncaptured loop on the "
          f"card: tokens, score {float(graph[plan.max_new]):.4f}, length "
          f"{int(graph[plan.max_new + 1])}, no-speech probability and "
          f"{graph.numel() - plan.max_new - 3} capture words")
    return graph


def beam_window_readings(asr, label: str, audio: np.ndarray) -> dict:
    """At ``audio``'s window: the beam graph path against the uncaptured
    loop (``check_beam_graph_equals_uncaptured``), the beam window's host ms
    a token (median of 3 windows, graphs captured), the kernel ms a step of
    its graph and of the greedy B = 1 graph of the same window beside it,
    and the loop's captures, graph pool and state bytes."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import beam as BM
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    loop = asr.decode_loop
    stats0 = dict(loop.stats)
    with torch.inference_mode():
        xa = asr._logmel_encode(torch.from_numpy(asr._pad_window(audio)).cuda())
    opts = asr._make_opts()
    plan = D.plan_window(asr.cfg, opts)
    packed = check_beam_graph_equals_uncaptured(asr, label, xa, plan)
    aux = torch.from_numpy(plan.aux).cuda()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = BM.beam_decode(asr.model, xa, opts, plan, aux, extra_suppress=asr._extra_suppress,
                             loop=loop)
        times.append(time.perf_counter() - t0)
    n_tokens = int(res.lengths[0])
    key, beam_ms = graph_step_ms(loop)
    if key.beam_size != opts.beam_size:
        raise AssertionError(f"{label}: the last loop shape is not the beam search's: {key}")
    D.greedy_decode(asr.model, xa, dataclasses.replace(opts, beam_size=1), plan, aux,
                    asr._extra_suppress, loop=loop)
    _, greedy_ms = graph_step_ms(loop)
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}

    def ms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    print(f"{label}: beam {opts.beam_size} over a {xa.shape[1] // 50} s window: "
          f"{1e3 * float(np.median(times)) / n_tokens:.2f} ms a token on the host clock (median "
          f"of 3 windows of {n_tokens} tokens, prefill included); kernels {ms(beam_ms)} a beam "
          f"step (B x K = {opts.beam_size} rows, self block {key.cache_len} x {opts.beam_size}) "
          f"beside the greedy B=1 step's {ms(greedy_ms)}; {graphs['captures']} captures in "
          f"{graphs['capture_s']:.2f} s, graph pool {loop.stats['graph_bytes'] / 2**20:.1f} MiB, "
          f"state buffers {graphs['state_bytes'] / 2**20:.1f} MiB, {graphs['replays']} replays")
    return {"xa": xa, "plan": plan, "packed": packed, "beam_ms": beam_ms, "greedy_ms": greedy_ms}


def check_sampler_card_equals_cpu(label: str) -> None:
    """The seeded sampler (``ops/threefry.py``) on an (8, 51865) logits
    tensor, rows of their own seed, position and temperature: the card's
    32-bit draws equal to the CPU's, its Gumbel values within 2 ulp (the
    same IEEE ops on both, so 0 is expected), the sampled tokens equal; with
    the sampler's device time."""
    import torch

    from realtime_whisper_asr_tpu_torch.ops import threefry

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(8, 51865, generator=gen) * 4.0
    seeds = torch.arange(8) + 7
    pos = torch.arange(8) * 13 + 5
    temps = torch.linspace(0.2, 1.0, 8)
    out = {}
    for dev in ("cpu", "cuda"):
        key = threefry.fold_in(threefry.prng_key(seeds.to(dev)), pos.to(dev))
        out[dev] = [threefry.random_bits(key, 51865).cpu(), threefry.gumbel(key, 51865).cpu(),
                    threefry.sample(logits.to(dev), seeds.to(dev), pos.to(dev),
                                    temps.to(dev)).cpu()]
    (bits, g, tok), (bits_c, g_c, tok_c) = out["cpu"], out["cuda"]
    ulp = int((g.view(torch.int32).long() - g_c.view(torch.int32).long()).abs().max())
    if not torch.equal(bits, bits_c) or ulp > 2 or not torch.equal(tok, tok_c):
        raise AssertionError(f"{label}: the card's sampler differs from the CPU's (bits equal "
                             f"{torch.equal(bits, bits_c)}, Gumbel {ulp} ulp, tokens "
                             f"{tok.tolist()} vs {tok_c.tolist()})")
    args = (logits.cuda(), seeds.cuda(), pos.cuda(), temps.cuda())
    sample_ms = time_cuda_ms(lambda: threefry.sample(*args), reps=10, cold=False)
    print(f"{label}: the sampler on the card equals the CPU's on (8, 51865) logits: bits equal, "
          f"Gumbel values within {ulp} ulp (tolerance 2), tokens equal {tok.tolist()}; "
          f"{sample_ms:.3f} ms of device time for the 8 rows (uncaptured)")


def run_ladder(asr, label: str, audio: np.ndarray) -> None:
    """``transcribe_with_fallback`` with ``logprob_threshold`` forced high,
    so that all five rungs run after the first pass (a loop shape captured
    before the call): the rungs' loop shapes equal (the temperature rides in
    the aux bundle), one capture in the call, its graph replayed by all five
    rungs; ``_sample_seed`` advanced by 5."""
    loop = asr.decode_loop
    keys = []
    loop_of = loop.loop

    def recording_loop(model, key, *args):
        keys.append(key)
        return loop_of(model, key, *args)

    loop.loop = recording_loop
    prev = asr.logprob_threshold
    asr.logprob_threshold = 1e9
    seed0, stats0 = asr._sample_seed, dict(loop.stats)
    t0 = time.perf_counter()
    try:
        res = asr.transcribe_with_fallback(audio)
    finally:
        del loop.loop
        asr.logprob_threshold = prev
    wall = time.perf_counter() - t0
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}
    rungs = keys[1:]
    if (len(keys) != 6 or len(set(rungs)) != 1 or rungs[0].opts.temperature != 1.0
            or rungs[0].beam_size != 1 or asr._sample_seed != seed0 + 5):
        raise AssertionError(f"{label}: the ladder ran {len(keys)} decodes, rung shapes "
                             f"{len(set(rungs))}, seed {seed0} -> {asr._sample_seed}")
    if graphs["captures"] != 1:  # the first pass's shape is captured already
        raise AssertionError(f"{label}: the five rungs took {graphs['captures']} captures")
    if not res.tokens or not all(0 <= t < asr.cfg.n_vocab for t in res.tokens):
        raise AssertionError(f"{label}: the ladder's result is empty or out of range")
    key, step_ms = graph_step_ms(loop)
    if key != rungs[0]:
        raise AssertionError(f"{label}: the last loop shape is not the rungs'")
    print(f"{label}: retry ladder (logprob_threshold forced high): the first pass (beam "
          f"{keys[0].beam_size}) then 5 sampled rungs at 0.2..1.0 on one loop shape: "
          f"{graphs['captures']} captures in the call (1 for the rungs), {graphs['replays']} "
          f"replays; seed {seed0} -> {asr._sample_seed}; {wall:.2f} s on the host clock; "
          f"{len(res.tokens)} tokens kept; kernels of a sampled step "
          + ("not measured" if step_ms is None else f"{step_ms:.3f} ms"))


def phase_beam(guard: FailOnLog, smi: str) -> None:
    """Beam search, the sampled retry ladder, ``detect_language`` and
    ``decode_full`` at full width (large-v3, random weights from seed 0,
    bf16, 32-token caps, word timestamps on):

    1. beam 5 over a 16 s window: the graph path bit-equal to the uncaptured
       loop (tokens, score, no-speech probability, capture); host ms a token
       and kernel ms a step beside greedy's B = 1 step; captures, pool and
       state bytes (``beam_window_readings``);
    2. the retry ladder (``run_ladder``), the sampler on the card against
       the CPU's, ``detect_language`` and ``decode_full``'s logits against
       ``decode_span``'s on one 32-token span;
    3. the same beam readings at ``int8-kv`` (``_attend_beam_q8``);
    4. ``int4`` beam 5 through ``transcribe``: K2's launches equal to the
       prediction (5 rows a loop step);
    5. beam 5 through ``StreamServer`` at ``int8-all``: N = 4 streams of 8 s
       of ``synthetic_speech`` in 1 s feeds (``run_capacity``): aggregate
       RTF, and the peak growth a stream under ``_row_bytes`` for 5 beams."""
    import gc

    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import LANGUAGES
    from realtime_whisper_asr_tpu_torch.ops import int4_matmul

    parts: dict[str, float] = {}
    t_part = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 1)
        t_part[0] = now

    def build(quantization):
        asr = TorchWhisperASR(model_size="large-v3", dtype=torch.bfloat16, device="cuda",
                              seed=0, quantization=quantization, beam_size=BEAM_SIZE)
        asr.transcribe_kargs["max_total_tokens"] = 32  # random weights never emit EOT
        return asr

    window = np.concatenate([golden_audio(i) for i in range(2)])  # 16 s
    label = "beam large-v3 bf16"
    asr = build(None)
    lap("init bf16")
    read = beam_window_readings(asr, label, window)
    lap("beam bf16")
    run_ladder(asr, label, window)
    check_sampler_card_equals_cpu(label)
    lang, prob = asr.detect_language(window)
    if lang not in LANGUAGES or not 0.0 < prob <= 1.0:
        raise AssertionError(f"{label}: detect_language gave {lang!r}, {prob}")
    print(f"{label}: detect_language over the 16 s window: {lang!r} with probability "
          f"{prob:.4f} (random weights)")
    xa = read["xa"]
    rng = np.random.default_rng(0)
    span = np.concatenate([read["plan"].init, rng.integers(0, asr.cfg.eot, 32 - len(read[
        "plan"].init))])
    tokens = torch.from_numpy(span).cuda()[None]
    with torch.inference_mode():
        full = asr.model.decode_full(tokens, xa)
        stepwise, _ = asr.model.decode_span(tokens, 0, asr.model.init_cache(xa, text_ctx=32))
    err, scale = float((full - stepwise).abs().max()), float(stepwise.abs().max())
    if not err <= 1e-2 * scale:
        raise AssertionError(f"{label}: decode_full's logits differ from decode_span's by {err} "
                             f"(scale {scale})")
    print(f"{label}: decode_full's logits on a 32-token span against decode_span's: max |Δ| "
          f"{err:.4g} over a scale of {scale:.4g} (tolerance 1e-2 x scale at bf16)")
    lap("ladder, sampler, language, decode_full")
    del asr, read, xa, full, stepwise
    gc.collect()
    torch.cuda.empty_cache()

    label = "beam large-v3 int8-kv"
    asr = build("int8-kv")
    lap("init int8-kv")
    beam_window_readings(asr, label, window)
    lap("beam int8-kv")
    del asr
    gc.collect()
    torch.cuda.empty_cache()

    label = "beam large-v3 int4"
    asr = build("int4")
    lap("init int4")
    loop = asr.decode_loop
    rows = count_k2_rows(asr.model)
    steps = record_loop_steps(loop)
    stats0 = dict(loop.stats)
    # ---- the int4 beam search, with K2's launch count read around it
    int4_matmul.int4_launches = 0
    res = asr.transcribe(window)
    launched = int4_matmul.int4_launches
    # ----
    del loop.loop, loop.run
    graphs = {k: loop.stats[k] - stats0[k] for k in loop.stats}
    if not res.tokens or set(steps) != {BEAM_SIZE}:
        raise AssertionError(f"{label}: tokens {res.tokens}, steps of {sorted(set(steps))} rows")
    predicted, formula = check_k2_launches(label, asr, rows, graphs, launched, True,
                                           steps=list(steps))
    print(f"{label}: K2 launches {launched} = predicted {predicted} ({formula}; each loop step "
          f"{BEAM_SIZE} rows); {len(res.tokens)} tokens")
    lap("beam int4")
    del asr
    gc.collect()
    torch.cuda.empty_cache()

    label = "beam serving large-v3 int8-all"
    asr = build("int8-all")
    lap("init int8-all")
    run = run_capacity(asr, BEAM_STREAMS, BEAM_SECONDS, label, guard)
    print(f"{label} on {smi}: beam {BEAM_SIZE}, N={BEAM_STREAMS} streams of {BEAM_SECONDS} s in "
          f"1 s feeds: aggregate RTF {run['rtf']:.4f} (wall {run['wall']:.2f} s; warm-up pass "
          f"{run['warm_s']:.1f} s, {run['warm_captures']} captures in it); {run['ticks']} ticks, "
          f"{run['new_tokens']} new tokens; batch sizes {sorted(set(run['sizes']))}; group "
          f"dispatch p50 {np.median(run['dispatch_ms']):.1f} ms; {run['graphs']['captures']} "
          f"captures after the warm-up; rows encoded {run['rows']} = K1 launches "
          f"{run['launches']}; PhaseTimer split of a group: "
          + ", ".join(f"{k} {v['mean_ms']}" for k, v in run["split"].items()))
    check_row_memory(asr, label, smi, run, (run["peak"] - run["base"]) / BEAM_STREAMS,
                     f"N={BEAM_STREAMS}: all the peak above the model over {BEAM_STREAMS} "
                     f"streams, an upper bound")
    lap("beam serving")
    del asr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase_beam seconds: {parts}")


def check_golden_beam(asr, guard: FailOnLog) -> None:
    """The golden test-tiny f32 ASR on the card (``phase_golden``'s): the
    ``beam5`` row of the fixture; a batched beam search of 3 streams at
    different states equal to each stream's own; ``transcribe_with_fallback``
    on golden clip 0 (every rung forced) token-equal to the port's on the
    CPU in this process; ``detect_language`` within 1e-4 of the CPU's; and
    ``decode_full`` within 1e-4 of ``decode_span``."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper import beam as BM
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        want = json.load(f)["matrix"]["beam5"]
    audio = golden_audio(0)
    asr.beam_size = 5
    try:
        res = asr.transcribe(audio)
    finally:
        asr.beam_size = 1
    got = {"tokens": [int(t) for t in res.tokens], "text": "".join(s.text for s in res).strip()}
    if got != want:
        raise AssertionError(f"golden beam5: {got} != recorded {want}")
    print("golden beam5 at f32: tokens and text equal the recorded row")

    opts = dataclasses.replace(asr._make_opts(), beam_size=3)
    requests = [{}, {"prefix_tokens": [50364, 40485]}, {"prompt_tokens": [1000, 2000]}]
    with torch.inference_mode():
        xa = torch.cat([asr._logmel_encode(torch.from_numpy(golden_audio(i)).cuda())
                        for i in range(3)])
    batched = BM.beam_decode_batch(asr.model, xa, opts, requests, loop=asr.decode_loop)
    plan = D.plan_batch_aux(asr.cfg, opts, requests)
    for i, (req, res) in enumerate(zip(requests, batched)):
        own = D.plan_window(asr.cfg, opts, req.get("prompt_tokens"), req.get("prefix_tokens"),
                            bucket=plan.p)
        one = BM.beam_decode(asr.model, xa[i : i + 1], opts, own,
                             torch.from_numpy(own.aux).cuda(), loop=asr.decode_loop)
        if not np.array_equal(res.tokens, one.tokens):
            raise AssertionError(f"golden batched beam row {i}: {res.tokens} != its own beam "
                                 f"search's {one.tokens}")
    print("golden batched beam 3 on the card: 3 streams at different states equal each "
          "stream's own beam search")

    cpu = TorchWhisperASR(cfg=asr.cfg, dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    cpu.transcribe_kargs["max_total_tokens"] = 24
    ladder = {}
    for name, one_asr in (("card", asr), ("cpu", cpu)):
        prev, seed = one_asr.logprob_threshold, one_asr._sample_seed
        one_asr.logprob_threshold = 1e9
        try:
            ladder[name] = one_asr.transcribe_with_fallback(audio).tokens
        finally:
            one_asr.logprob_threshold, one_asr._sample_seed = prev, seed
    if ladder["card"] != ladder["cpu"]:
        raise AssertionError(f"golden ladder: the card's tokens {ladder['card']} != the CPU's "
                             f"{ladder['cpu']}")
    langs = {name: a.detect_language(audio) for name, a in (("card", asr), ("cpu", cpu))}
    if (langs["card"][0] != langs["cpu"][0]
            or abs(langs["card"][1] - langs["cpu"][1]) >= 1e-4):
        raise AssertionError(f"golden detect_language: card {langs['card']} != CPU "
                             f"{langs['cpu']}")
    tokens = torch.tensor([[asr.cfg.sot, 50259, 50359] + list(range(1000, 1029))]).cuda()
    with torch.inference_mode():
        full = asr.model.decode_full(tokens, xa[:1])
        stepwise, _ = asr.model.decode_span(tokens, 0, asr.model.init_cache(xa[:1], text_ctx=32))
    err = float((full - stepwise).abs().max())
    if err > 1e-4 * float(stepwise.abs().max()) + 1e-5:
        raise AssertionError(f"golden decode_full: logits differ from decode_span's by {err}")
    if guard.records:
        raise AssertionError(f"golden beam: logged errors {guard.records}")
    print(f"golden f32 ladder (every rung forced): card tokens equal the CPU's "
          f"({len(ladder['cpu'])} tokens); detect_language card {langs['card'][0]!r} "
          f"{langs['card'][1]:.6f} vs CPU {langs['cpu'][1]:.6f} (tolerance 1e-4); decode_full vs "
          f"decode_span max |Δ| {err:.3g} (tolerance 1e-4 x scale + 1e-5)")


# ----------------------------------------------------- the application path


def music_backed_speech(seconds: float, seed: int = 0) -> np.ndarray:
    """bench.py's scenario 5 audio (bench.py:58-64): its synthetic speech
    over a chord of 220, 330 and 55 Hz tones."""
    speech = synthetic_speech(seconds, seed)
    t = np.arange(int(seconds * SR)) / SR
    music = 0.15 * (np.sin(2 * np.pi * 220 * t) + 0.7 * np.sin(2 * np.pi * 330 * t)
                    + 0.5 * np.sin(2 * np.pi * 55 * t))
    return (speech + music.astype(np.float32)).astype(np.float32)


#: the separation's window buckets (the ASR's 8/16/30 s windows, which the
#: fused frontend separates) and its tolerances, card against the CPU with
#: TF32 off: f32 convolutions summed in other orders (cuDNN's algorithms)
SEP_BUCKETS_S = (8, 16, 30)
SEP_TOL = 1e-4
#: the phase vocoder's: the card's atan2 against the CPU's differs in the
#: last bit, and a phase of thousands of radians carries it (the same gap as
#: the port's CPU run against the JAX package's, tests/test_torch_dsp.py)
STRETCH_TOL, PHASE_TOL = 2e-3, 0.05


def sep_macs_per_bin(params: dict) -> int:
    """Multiply-adds per time-frequency bin of the separator's convolutions
    (9 taps x input x output channels each): 17,784 for the default net."""
    from realtime_whisper_asr_tpu_torch.models import separation_nn as SEP

    widths = [SEP._in_out(params[f"enc{i}_w"]) for i in range(SEP._n_layers(params))]
    widths.append(SEP._in_out(params["out_w"]))
    return sum(9 * c_in * c_out for c_in, c_out in widths)


def phase_separation(smi: str) -> None:
    """The separation path's library calls on the card against the same
    functions on the CPU (TF32 off): ``separate_vocals`` and
    ``separate_stems_device`` for the three packaged variants at the 8, 16
    and 30 s buckets (music-backed speech), the band-pass, the phase
    vocoder over three chunks with its carried phase (each chunk given the
    CPU's phase) and the dedup features (B = 3, a valid prefix). Prints
    max |delta| against each tolerance, then the default net's device time a
    window (CUDA events, L2 flushed, median of 30) at each bucket beside its
    bound (its f32 operations against the card's f32 peak, or its bytes)
    and the small net's at 16 s; then each stage's host ms a call (median
    of 10, the host clock, the copies back included) as the app calls it."""
    import torch

    from realtime_whisper_asr_tpu_torch.models import separation_nn as SEP
    from realtime_whisper_asr_tpu_torch.ops import dsp, features

    worst = {}
    with torch.inference_mode():
        for variant in ("default", "small", "4stem"):
            host = dict(np.load(SEP.VARIANT_WEIGHTS[variant]))
            card, cpu = SEP.params_from_jax(host, "cuda"), SEP.params_from_jax(host, "cpu")
            for sec in SEP_BUCKETS_S:
                x = torch.from_numpy(music_backed_speech(sec, seed=sec))
                ref = SEP.separate_stems_device(cpu, x)
                stems = SEP.separate_stems_device(card, x.cuda()).cpu()
                vocals = SEP.separate_vocals(card, x.cuda()).cpu()
                err = max(float((stems - ref).abs().max()), float((vocals - ref[0]).abs().max()))
                worst[f"{variant} {sec} s"] = err
        bp = {}
        for n in (16384, 65536, 262144):
            x = torch.from_numpy(music_backed_speech(n / SR, seed=n))
            bp[n] = float((dsp.bandpass_filter(x.cuda()).cpu() - dsp.bandpass_filter(x)).abs().max())
        x = music_backed_speech(3.0, seed=3)
        st_err, ph_err = 0.0, 0.0
        for rate in (0.8, 1.25):
            phase = torch.zeros(513)
            for c in range(3):
                seg = torch.from_numpy(x[c * SR : (c + 1) * SR])
                ref, ref_phase = dsp.time_stretch(seg, rate, phase_in=phase, carry_phase=True)
                got, got_phase = dsp.time_stretch(seg.cuda(), rate, phase_in=phase.cuda(),
                                                  carry_phase=True)
                st_err = max(st_err, float((got.cpu() - ref).abs().max()))
                ph_err = max(ph_err, float((got_phase.cpu() - ref_phase).abs().max()))
                phase = ref_phase
        chunks = torch.from_numpy(np.stack([music_backed_speech(16384 / SR, seed=s)
                                            for s in range(3)]))
        chunks[:, 12000:] = 0
        ft_err = float((features.dedup_features(chunks.cuda(), n_valid=12000).cpu()
                        - features.dedup_features(chunks, n_valid=12000)).abs().max())
    sep_err = max(worst.values())
    print(f"separation on {smi}: separate_vocals and separate_stems_device, card vs CPU "
          f"(TF32 off), max |delta| over 3 variants x {SEP_BUCKETS_S} s {sep_err:.3g} (tolerance "
          f"{SEP_TOL:g}; " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + ")")
    print(f"separation on {smi}: bandpass_filter max |delta| {max(bp.values()):.3g} (tolerance "
          f"1e-5); time_stretch (rates 0.8, 1.25, 3 chunks, carried phase) output "
          f"{st_err:.3g} (tolerance {STRETCH_TOL:g}), phase {ph_err:.3g} rad (tolerance "
          f"{PHASE_TOL:g}); dedup_features (B = 3, n_valid) {ft_err:.3g} (tolerance 1e-5)")
    if (sep_err > SEP_TOL or max(bp.values()) > 1e-5 or st_err > STRETCH_TOL
            or ph_err > PHASE_TOL or ft_err > 1e-5):
        raise AssertionError("separation: the card disagrees with the CPU beyond a tolerance")
    for variant, secs in (("default", SEP_BUCKETS_S), ("small", (16,))):
        host = dict(np.load(SEP.VARIANT_WEIGHTS[variant]))
        card = SEP.params_from_jax(host, "cuda")
        macs = sep_macs_per_bin(host)
        weight_bytes = sum(v.size * 4 for v in host.values())
        for sec in secs:
            n = sec * SR
            x = torch.from_numpy(music_backed_speech(sec)).cuda()
            with torch.inference_mode():
                ms = time_cuda_ms(lambda: SEP.separate_vocals(card, x))
            bins = (1 + n // SEP.HOP) * SEP.F_BINS
            ops = 2 * macs * bins
            bound_ms, bound_by = _bound(8 * n + weight_bytes, ops, PEAK_F32_FLOPS)
            print(f"separation on {smi}: {variant} net ({macs:,} MACs a bin), {sec} s window "
                  f"({bins:,} bins, {ops / 1e9:.1f} GFLOP): {ms:.3f} ms device (CUDA events, L2 "
                  f"flushed, median of 30); bound {bound_ms:.3f} ms ({bound_by}); "
                  f"{ops / ms / 1e9:.1f} TFLOP/s")
    print(f"stages on {smi}: host ms a call (median of 10): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stage_host_ms().items()))


def stage_host_ms() -> dict:
    """Host ms of one call of each stage the app can run on a chunk, as it
    calls them (median of 10 after 2 warm-up calls): the dedup gate (numpy
    features, and the card's), the band-pass and the neural separator on
    the card and on the host, the time stretch on the card, the speaker
    embedding of a 2 s utterance."""
    from realtime_whisper_asr_tpu_torch.models.separation_nn import NeuralSeparator
    from realtime_whisper_asr_tpu_torch.models.speaker import SpeakerEmbedder
    from realtime_whisper_asr_tpu_torch.pipeline import (
        AudioDeduplicator,
        BandpassSeparator,
        SpeechRateAudioProcessor,
    )

    chunk = music_backed_speech(1.0, seed=5)
    stretch = SpeechRateAudioProcessor()
    stages = {
        "dedup (numpy, 1 s)": AudioDeduplicator(time_window_s=0.0).should_skip,
        "dedup (card features, 1 s)": AudioDeduplicator(use_device=True,
                                                        time_window_s=0.0).should_skip,
        "band-pass (card, 1 s)": BandpassSeparator().separate,
        "neural separator (card, 1 s)": NeuralSeparator().separate,
        "neural separator (host mirror, 1 s)": NeuralSeparator(use_device=False).separate,
        "time stretch (card, 1 s at 0.8)": lambda c: stretch.process(c, 20.0),
        "speaker embedding (2 s)": lambda c: SpeakerEmbedder()(np.concatenate([c, c])),
    }
    out = {}
    for name, fn in stages.items():
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            fn(chunk)
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = float(np.median(times[2:]))
    return out


def _app_case(name: str) -> dict:
    """The parity cases of tests/test_torch_app.py: bench.py's scenarios 2-5
    (run_scenario's overrides, their models cut to test-tiny) and the
    speech-rate features with diarization."""
    off = {"audio_deduplication.enable": False, "skip_detector.enable": False,
           "speech_rate_adaptive.enable": False}
    return {
        "scenario2": dict(language="en", overrides=dict(off)),
        "scenario3": dict(language="zh", overrides={"skip_detector.enable": True,
                                                    "streaming.agreement_n": 2,
                                                    "audio_deduplication.enable": False}),
        "scenario4": dict(language="en", task="translate", quantization="int8-all",
                          overrides=dict(off, **{"audio_deduplication.enable": True,
                                                 "streaming.prefix_policy": "last"})),
        "scenario5": dict(language="en", quantization="int8-all", music=True,
                          overrides=dict(off, **{"vocal_separation.enable": True,
                                                 "vocal_separation.method": "neural",
                                                 "vocal_separation.fuse_encode": True,
                                                 "streaming.prefix_policy": "last"})),
        "rate-diarize": dict(language="en", seconds=12.0,
                             overrides={"audio_deduplication.enable": False,
                                        "asr_optimization.time_stretch_enable": True,
                                        "asr_optimization.adaptive_params_enable": True,
                                        "diarization.enable": True,
                                        "diarization.min_audio_s": 0.3}),
    }[name]


APP_CASES = ("scenario2", "scenario3", "scenario4", "scenario5", "rate-diarize")


def golden_asr(device: str, quantization=None):
    """The golden test-tiny weights at f32 on ``device``, 24-token caps."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

    asr = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device=device,
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                          quantization=quantization)
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    return asr


def app_session(device: str, name: str, guard: FailOnLog) -> dict:
    """One parity case through the port's StreamingApp on ``device``: the
    golden ASR, a stepping fake clock, 1 s chunks of bench.py's feed ->
    the lines, stats and stage readings, and each decoded window's inputs
    and tokens (for a near-tie diagnosis)."""
    from realtime_whisper_asr_tpu_torch.app import StreamingApp
    from realtime_whisper_asr_tpu_torch.config import ConfigManager
    from realtime_whisper_asr_tpu_torch.io import SimulatedMicStream

    case = _app_case(name)
    asr = golden_asr(device, case.get("quantization"))
    if case.get("task") == "translate":
        asr.set_translate_task()
    asr.original_language = case["language"]
    windows, calls = [], []
    dispatch, finalize = asr._transcribe_window_dispatch, asr._transcribe_window_finalize

    def recording_dispatch(audio, init_prompt, time_offset, prefix_ids=None, draft_ids=None,
                           prompt_ids=None, device_draft=None):
        calls.append((np.array(audio), init_prompt, list(prefix_ids or []), prompt_ids))
        return dispatch(audio, init_prompt, time_offset, prefix_ids, draft_ids, prompt_ids,
                        device_draft)

    def recording_finalize(st):
        res = finalize(st)
        windows.append((calls.pop(0), [int(t) for t in res.tokens]))
        return res

    asr._transcribe_window_dispatch = recording_dispatch
    asr._transcribe_window_finalize = recording_finalize
    cm = ConfigManager(autoload=False)
    cm.set("performance.display_interval_s", 1e9)
    for k, v in case["overrides"].items():
        cm.set(k, v)
    now = {"t": 0.0}

    def clock():
        now["t"] += 0.01
        return now["t"]

    lines = []
    app = StreamingApp(config=cm, asr=asr, language=case["language"],
                       task=case.get("task", "transcribe"), output=lines.append, clock=clock,
                       device=device)
    seconds = case.get("seconds", 8.0)
    audio = music_backed_speech(seconds) if case.get("music") else synthetic_speech(seconds)
    stats = app.record_session(SimulatedMicStream(audio), chunk_seconds=1.0)
    app.output.flush()
    app.shutdown()
    if guard.records:
        raise AssertionError(f"app {name} on {device}: an exception was swallowed: "
                             f"{guard.records}")
    return {"lines": lines, "stats": dict(stats.__dict__), "clock": now["t"],
            "fused": app.fused_separation, "pipeline": app.last_session_pipeline,
            "stretch": dict(app.stretch_processor.stats) if app.stretch_processor else None,
            "diarizer": app.diarizer.get_stats() if app.diarizer else None,
            "_windows": windows, "_asr": asr}


def _window_near_tie(card, cpu, call, got: list, want: list) -> tuple[str, bool]:
    """A window whose inputs agree and whose tokens part: teacher-forced
    along the CPU's tokens with the window's prompt and prefix, the card's
    logits against the CPU's -> (diagnosis, whether it is a near-tie flip:
    the CPU's margin between its token and the card's within the card-vs-CPU
    logit difference already seen on the steps before it)."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    audio, init_prompt, prefix, prompt_ids = call
    i = next(j for j in range(min(len(want), len(got)) + 1)
             if j == min(len(want), len(got)) or want[j] != got[j])
    if i >= min(len(want), len(got)):
        return f"lengths part at {i}: {got} vs {want}", False
    logits = []
    for asr in (card, cpu):
        ids = prompt_ids if prompt_ids is not None else (
            asr.tokenizer.encode(init_prompt) if init_prompt else None)
        plan = D.plan_window(asr.cfg, asr._make_opts(), ids, prefix or None)
        asr._sync_audio_and_aux(audio, plan.aux)
        with torch.inference_mode():
            xa = asr._encode_from_buf(len(audio))
            seq = torch.from_numpy(np.concatenate([plan.init, want[: i + 1]]).astype(np.int64))
            out, _ = asr.model.decode_span(seq[None].to(xa.device), 0,
                                           asr.model.init_cache(xa, text_ctx=448))
        p = len(plan.init)
        logits.append(out[0, p - 1 : p + i].float().cpu().numpy())
    card_l, cpu_l = logits
    margin = float(cpu_l[i, want[i]] - cpu_l[i, got[i]])
    noise = float(np.abs(card_l[:i] - cpu_l[:i]).max()) if i else 0.0
    msg = (f"token {i} (CPU {want[i]}, card {got[i]}): CPU margin {margin:.4g}, card-vs-CPU "
           f"max |dlogit| {noise:.4g} over the {i} agreeing steps")
    return msg, 0 <= margin <= noise


def phase_app_golden(guard: FailOnLog, smi: str) -> list[str]:
    """The golden test-tiny weights at f32 through the port's StreamingApp on
    the card and on the CPU, in the parity cases' feature sets (bench.py's
    scenarios 2-5 at test-tiny, 5 with the neural separator fused into the
    encode; the time stretch, adaptive decode parameters and diarization):
    the lines (speaker labels included), SessionStats, stage readings and
    clock must be equal. A difference is diagnosed at its first window whose
    inputs agree and tokens part (as phase_golden_quant does): a near-tie
    flip is printed and returned, anything else fails. Then
    ``StreamServer(diarize=True, separator=<the trained neural net>)`` on 2
    golden streams (the VAC clip, and clips 1 and 2 around a pause) with the
    Silero-like VAD: each result's text and speaker label card == CPU."""
    flips = []
    for name in APP_CASES:
        t0 = time.perf_counter()
        card, cpu = app_session("cuda", name, guard), app_session("cpu", name, guard)
        wc, wp = card.pop("_windows"), cpu.pop("_windows")
        acard, acpu = card.pop("_asr"), cpu.pop("_asr")
        if card == cpu:
            print(f"app golden {name}: card == CPU: {len(card['lines'])} lines, stats "
                  f"{card['stats']}, pipeline {card['pipeline']}, fused separation "
                  f"{card['fused']}, stretch {card['stretch']}, diarizer {card['diarizer']} "
                  f"({time.perf_counter() - t0:.1f} s)")
            continue
        k = next((j for j, (a, b) in enumerate(zip(wc, wp)) if a[1] != b[1]), None)
        if k is None or not all(np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
                                for x, y in zip(wc[k][0], wp[k][0])):
            raise AssertionError(f"app golden {name}: card {card} != CPU {cpu}, no window with "
                                 f"equal inputs and parting tokens")
        msg, tie = _window_near_tie(acard, acpu, wp[k][0], wc[k][1], wp[k][1])
        msg = f"app golden {name}: NEAR-TIE FLIP at window {k}: {msg}"
        print(msg)
        if not tie:
            raise AssertionError(f"app golden {name}: card {card} != CPU {cpu}: {msg}")
        flips.append(msg)
    server_out = {device: _serve_diarized(device, guard) for device in ("cuda", "cpu")}
    if server_out["cuda"] != server_out["cpu"]:
        raise AssertionError(f"app golden server: card {server_out['cuda']} != CPU "
                             f"{server_out['cpu']}")
    labels = sorted({r[3] for rows in server_out["cuda"] for r in rows if r[3]})
    print(f"app golden server (diarize=True, the trained separator fused, Silero-like VAD): "
          f"results and speaker labels card == CPU, "
          f"{[len(rows) for rows in server_out['cuda']]} results, labels {labels}")
    return flips


def _serve_diarized(device: str, guard: FailOnLog) -> list:
    from realtime_whisper_asr_tpu_torch.models.separation_nn import NeuralSeparator
    from realtime_whisper_asr_tpu_torch.serving import StreamServer

    asr = golden_asr(device)
    server = StreamServer(asr, online_chunk_size=0.5, prefix_policy="last", diarize=True,
                          separator=NeuralSeparator(device=device), clock=lambda: 0.0)
    if not server.fused_separation or asr._sep_frontend is None:
        raise AssertionError("app golden server: the trained separator was not fused")
    pause = np.zeros(int(1.2 * SR), np.float32)
    audios = [golden_vac_audio(), np.concatenate([golden_audio(1, 3.0), pause,
                                                  golden_audio(2, 3.0), pause])]
    sids = [server.create_stream() for _ in audios]
    out = {sid: [] for sid in sids}
    for pos in range(0, max(len(a) for a in audios), SR // 2):
        for sid, audio in zip(sids, audios):
            if pos < len(audio):
                server.feed(sid, audio[pos : pos + SR // 2])
        while server.step():
            pass
        for sid in sids:
            out[sid].extend(server.poll(sid))
    for sid in sids:
        out[sid].extend(server.close_stream(sid))
    if server.group_failures or guard.records:
        raise AssertionError(f"app golden server on {device}: {server.group_failures} group "
                             f"failures, {guard.records}")
    return [[(round(r.begin, 3), round(r.end, 3), r.text, r.speaker) for r in out[sid]]
            for sid in sids]


#: bench.py's scenario 5 (bench.py:128-142) through the port's StreamingApp:
#: 16 s passes (bench.py's 24 s, cut for time)
APP_SECONDS = 16
APP_SCENARIO5 = {"audio_deduplication.enable": False, "skip_detector.enable": False,
                 "speech_rate_adaptive.enable": False, "vocal_separation.enable": True,
                 "vocal_separation.method": "neural", "vocal_separation.fuse_encode": True,
                 "streaming.prefix_policy": "last", "model.quantization": "int8-all"}


def _timed(fn, spans: list):
    """fn, appending each call's host ms to ``spans``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        spans.append(1e3 * (time.perf_counter() - t0))
        return out
    return call


def _peak_bytes(fn) -> int:
    """Bytes the card's allocator held at its peak during fn() above what it
    held before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_app(guard: FailOnLog, smi: str) -> int:
    """bench.py's scenario 5 through the port's StreamingApp at full width:
    the configuration names large-v3 (bf16, random weights from seed 0) at
    ``int8-all``, prefix policy "last", VAC with the Silero-like VAD on the
    card and the packaged default separator fused into the encode;
    96-token caps, 4 tokens a second; ``music_backed_speech`` in 1 s chunks
    fed back to back (the session picks async pipelined ticks). A warm-up
    pass, then a timed one of ``APP_SECONDS``, K1's launches set to 0 just
    before it and read just after: they must equal the windows encoded, with
    no capture and no swallowed exception. Prints the RTF, results and
    skips, the separation's device ms a window beside the encode's, the
    frontend's peak memory a row at the 30 s bucket beside what
    ``_row_bytes`` reserves for it (a breach fails), and a PhaseTimer split
    of one more (synchronous) pass. -> K1's launches."""
    import torch

    from realtime_whisper_asr_tpu_torch import serving
    from realtime_whisper_asr_tpu_torch.app import StreamingApp
    from realtime_whisper_asr_tpu_torch.config import ConfigManager
    from realtime_whisper_asr_tpu_torch.io import SimulatedMicStream
    from realtime_whisper_asr_tpu_torch.models import separation_nn as SEP
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.services import PerformanceMonitor
    from realtime_whisper_asr_tpu_torch.utils.profiling import PhaseTimer

    label = "app scenario 5 large-v3 int8-all"
    cm = ConfigManager(autoload=False)
    cm.set("model.size", "large-v3")
    cm.set("performance.display_interval_s", 1e9)
    for k, v in APP_SCENARIO5.items():
        cm.set(k, v)
    t0 = time.perf_counter()
    lines = []
    app = StreamingApp(config=cm, language="en", output=lines.append)
    asr = app.asr
    asr.transcribe_kargs.update(max_new_tokens=96, max_total_tokens=96)
    asr.max_tokens_per_second = 4.0
    torch.cuda.synchronize()
    if not app.fused_separation or asr._sep_frontend is None or asr.quantization != "int8-all":
        raise AssertionError(f"{label}: not the scenario's configuration")
    print(f"{label}: app built in {time.perf_counter() - t0:.1f} s (random init, int8 "
          f"quantization, the packaged separator fused, VAD {type(app.processor.vac.prob_fn).__name__})")
    audio = music_backed_speech(APP_SECONDS)
    stream = SimulatedMicStream(np.concatenate([audio] * 3))  # warm-up, timed, PhaseTimer
    t0 = time.perf_counter()
    app.record_session(stream, chunk_seconds=1.0, max_seconds=APP_SECONDS, until_exhausted=False)
    torch.cuda.synchronize()
    print(f"{label}: warm-up pass in {time.perf_counter() - t0:.1f} s")
    app.processor.init()
    app.monitor = PerformanceMonitor()
    loop = asr.decode_loop
    stats0 = dict(loop.stats)
    rows = [0]
    encode_many = asr._encode_many

    def counting(keys, n_samples_list):
        rows[0] += len(keys)
        return encode_many(keys, n_samples_list)

    asr._encode_many = counting
    spans = {"insert_audio_chunk": [], "process_iter": []}
    for name in spans:
        setattr(app.processor, name, _timed(getattr(app.processor, name), spans[name]))
    # ---- the app path, with K1's launch count read around it
    logmel.logmel_launches = 0
    t0 = time.perf_counter()
    stats = app.record_session(stream, chunk_seconds=1.0, max_seconds=APP_SECONDS,
                               until_exhausted=False)
    wall = time.perf_counter() - t0
    launches = logmel.logmel_launches
    # ----
    del asr._encode_many, app.processor.insert_audio_chunk, app.processor.process_iter
    captures = loop.stats["captures"] - stats0["captures"]
    if guard.records:
        raise AssertionError(f"{label}: the session swallowed an exception: {guard.records}")
    if launches == 0 or launches != rows[0] or captures or stats.chunks != APP_SECONDS:
        raise AssertionError(f"{label}: K1 launched {launches} times for {rows[0]} windows "
                             f"encoded, {captures} captures, {stats.chunks} chunks")
    mon = app.monitor.get_status()
    print(f"{label} on {smi}: RTF {wall / APP_SECONDS:.4f} ({wall:.2f} s for {APP_SECONDS} s of "
          f"music-backed speech, 1 s chunks back to back, pipeline "
          f"{app.last_session_pipeline}); results {stats.results}, skips {stats.skipped}, "
          f"dedup skips {stats.dedup_skipped}; monitor p50 {mon.get('p50_ms')} ms; "
          f"{rows[0]} windows encoded = K1 launches {launches}; {captures} captures after the "
          f"warm-up pass")
    ins, tick = sum(spans["insert_audio_chunk"]), sum(spans["process_iter"])
    print(f"{label} on {smi}: the session's host time: insert_audio_chunk (the VAD on the card, "
          f"the ring's prefetch) {ins:.1f} ms ({ins / stats.chunks:.2f} a chunk), process_iter "
          f"{tick:.1f} ms ({tick / stats.chunks:.2f} a chunk), the rest (app stages, sinks, the "
          f"final flush) {1e3 * wall - ins - tick:.1f} ms")
    # the separation's device time a window beside the encode's, at 16 s
    key = next(iter(asr._buffers))
    sep, dil = asr._sep_frontend
    n16 = 16 * SR
    ring16 = asr._buffers[key][0][:n16]
    with torch.inference_mode():
        sep_ms = time_cuda_ms(lambda: SEP.separate_vocals(sep, ring16[None], dil=dil))
        fused_ms = time_cuda_ms(lambda: asr._encode_many([key], [n16]))
        asr._sep_frontend = None
        enc_ms = time_cuda_ms(lambda: asr._encode_many([key], [n16]))
        asr._sep_frontend = (sep, dil)
        ring30 = asr._buffers[key][0][: 30 * SR]
        one = _peak_bytes(lambda: SEP.separate_vocals(sep, ring30[None], dil=dil))
        four = _peak_bytes(lambda: SEP.separate_vocals(sep, ring30.expand(4, -1), dil=dil))
    print(f"{label} on {smi}: a 16 s window's separation {sep_ms:.3f} ms device, its encode "
          f"(K1 and the encoder) {enc_ms:.3f} ms, both fused {fused_ms:.3f} ms (CUDA events, L2 "
          f"flushed, median of 30)")
    reserved = SEP.separation_bytes(sep, 30 * SR)
    cfg = asr.cfg
    itemsize = asr.model.dtype.itemsize
    row_on = serving._row_bytes(cfg, False, itemsize, 1, sep)
    row_off = serving._row_bytes(cfg, False, itemsize, 1)
    print(f"{label} on {smi}: the frontend's peak at the 30 s bucket {one / 2**20:.1f} MiB for "
          f"one row, {four / 2**20:.1f} MiB for 4 ({four / 4 / 2**20:.1f} MiB a row); "
          f"_row_bytes reserves {reserved / 2**20:.1f} MiB a row for it ({row_off / 2**20:.1f} "
          f"-> {row_on / 2**20:.1f} MiB)")
    if one > reserved or four > 4 * reserved or row_on - row_off != reserved:
        raise AssertionError(f"{label}: the separation's transient exceeds what _row_bytes "
                             f"reserves")
    # a tick's phases: synchronous ticks (the timer waits at each boundary)
    app.processor.init()
    app._pipeline_auto = False
    app.online.set_pipeline(False)
    asr.phase_timer = PhaseTimer()
    app.record_session(stream, chunk_seconds=1.0, max_seconds=APP_SECONDS, until_exhausted=False)
    report = asr.phase_timer.report()
    asr.phase_timer = None
    app.shutdown()
    if guard.records:
        raise AssertionError(f"{label}: the session swallowed an exception: {guard.records}")
    print(f"{label} on {smi}: PhaseTimer split of a synchronous tick (mean ms over "
          f"{report['decode']['count']} ticks; encode includes the separation): "
          + ", ".join(f"{k} {v['mean_ms']}" for k, v in report.items()))
    return launches


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
#: the cross-K/V projection at the 16 s bucket; the serving phase's batched
#: shapes (8 rows x a span: 8 x 8, 8 x (128 + 16 draft slots); the
#: cross-K/V of 8 windows of 8 s; its steps are M = 8); and test-tiny's (one scale
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
    ("batch span qkv M=64", 64, 1280, 3840),
    ("batch span fc2 M=1152", 1152, 5120, 1280),
    ("cross-K/V 8 x 8 s", 3200, 1280, 1280),
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
    asr._sync_audio_and_aux(audio, plan.aux)
    p = len(plan.init)
    with torch.inference_mode():
        xa = asr._encode_from_buf(len(audio))
        seq = torch.from_numpy(np.concatenate([plan.init, tokens]).astype(np.int64))
        logits, _ = asr.model.decode_span(seq[None].to(xa.device), 0,
                                          asr.model.init_cache(xa, text_ctx=128))
    return logits[0, p - 1 : p - 1 + len(tokens)].float().cpu().numpy()


def check_golden_prequant(asr8, row8: dict, matrix: dict) -> None:
    """The golden ``prequant`` row on the card: ``asr8``'s ``int8-all``
    model (the golden weights at f32) saved in the port's native format,
    reloaded through ``TorchWhisperASR(checkpoint_dir=)`` as a pre-quantized
    artifact, 24-token cap: its tokens and text equal the card's
    ``int8-all`` run (``row8``) and, when that run equals the recorded
    ``int8all`` row, the recorded ``prequant`` row with ``matches_int8all``."""
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, asr8.model.state_dict(), asr8.cfg)
        asr = TorchWhisperASR(checkpoint_dir=d, dtype=torch.float32, device="cuda")
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    res = asr.transcribe(golden_audio(0))
    row = {"tokens": [int(t) for t in res.tokens],
           "text": "".join(seg.text for seg in res).strip()}
    row["matches_int8all"] = row["tokens"] == matrix["int8all"]["tokens"]
    if asr.quantization != "int8-all" or row["tokens"] != row8["tokens"]:
        raise AssertionError(f"golden prequant on the card: {asr.quantization} artifact "
                             f"tokens {row['tokens']} != the card's int8-all {row8['tokens']}")
    if row8 == matrix["int8all"] and row != matrix["prequant"]:
        raise AssertionError(f"golden prequant on the card: {row} != recorded "
                             f"{matrix['prequant']}")
    print(f"golden prequant at f32 on the card (the int8-all model saved in the port's format, "
          f"reloaded as a pre-quantized artifact): tokens equal the card's int8-all run; "
          + ("tokens and text equal the recorded row, matches_int8all true"
             if row == matrix["prequant"] else "the recorded row differs as int8all does"))


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
        if tier == "int8-all":
            check_golden_prequant(asr, row, matrix)
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



# ---------------------------------------------------------------- CLI, training


def _run_cli(argv: list) -> str:
    """``cli.main(argv)``'s standard output; a non-zero status fails."""
    import io

    from realtime_whisper_asr_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    logging.captureWarnings(False)  # the CLI routes warnings into logging
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}: {buf.getvalue()[-500:]}")
    return buf.getvalue()


def golden_checkpoint(path: str) -> str:
    """The golden test-tiny weights written as the port's native checkpoint."""
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import save_checkpoint
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

    save_checkpoint(path, load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                    get_config("test-tiny"))
    return path


def write_manifest(d: str, clips: list) -> str:
    """A JSONL manifest of ``speechy_audio`` WAVs: ``clips`` is a list of
    (seconds, word count); clip i says words w<i>, w<i+1>, ..."""
    from realtime_whisper_asr_tpu_torch.io import write_wav

    path = os.path.join(d, "manifest.jsonl")
    with open(path, "w") as f:
        for i, (seconds, words) in enumerate(clips):
            wav = os.path.join(d, f"clip{i}.wav")
            write_wav(wav, speechy_audio(seconds, seed=i))
            text = " ".join(f"w{i + j}" for j in range(words))
            f.write(json.dumps({"wav": wav, "text": text, "language": "en"}) + "\n")
    return path


def phase_cli(smi: str) -> int:
    """The port's CLI as a user runs it, on the card: ``detect`` names the
    card and recommends from its memory; ``transcribe`` of golden clip 0 on
    the golden weights (a native checkpoint) prints the golden row's text in
    its first 8 segments, and its ``--output-format srt`` bytes equal the
    ``--cpu`` run's; ``stream --wav`` runs one session. Returns K1's
    launches in the card's transcribe and stream."""
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.io import write_wav
    from realtime_whisper_asr_tpu_torch.ops import logmel

    report = json.loads(_run_cli(["detect"]))
    hw, rec = report["hardware"], report["recommendation"]
    props = torch.cuda.get_device_properties(0)
    if (hw["platform"], hw["device_kind"], hw["hbm_bytes"], hw["n_devices"]) != (
            "gpu", torch.cuda.get_device_name(0), props.total_memory, torch.cuda.device_count()):
        raise AssertionError(f"cli detect: {hw}")
    if rec["model"] != "large-v3":
        raise AssertionError(f"cli detect recommends {rec} on {hw['hbm_bytes']} bytes")
    print(f"cli detect: {hw['device_kind']} x{hw['n_devices']}, compute capability "
          f"{hw['compute_capability']}, {hw['hbm_bytes'] / 2**30:.1f} GiB -> {rec['model']} "
          f"{rec['dtype']} ({rec['reason']}); {smi}")
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        golden_text = json.load(f)["clips"][0]["offline_text"]
    with tempfile.TemporaryDirectory() as d:
        ckpt = golden_checkpoint(os.path.join(d, "ckpt"))
        wav = os.path.join(d, "golden0.wav")
        write_wav(wav, golden_audio(0))
        common = ["--dtype", "float32", "--checkpoint", ckpt, "--config",
                  os.path.join(d, "config.json")]
        logmel.logmel_launches = 0
        listing = _run_cli(["transcribe", wav] + common)
        launches = logmel.logmel_launches
        texts = [ln.split("] ", 1)[1] for ln in listing.splitlines() if "-->" in ln]
        if "".join(texts[:8]) != golden_text:
            raise AssertionError(f"cli transcribe: {texts[:8]} is not the golden {golden_text!r}")
        srt = {dev: _run_cli(["transcribe", wav, "--output-format", "srt"] + common + extra)
               for dev, extra in (("cuda", []), ("cpu", ["--cpu"]))}
        if srt["cuda"].encode() != srt["cpu"].encode():
            card, cpu = srt["cuda"].splitlines(), srt["cpu"].splitlines()
            first = next(i for i, (a, b) in enumerate(zip(card + [""], cpu + [""])) if a != b)
            raise AssertionError(f"cli transcribe srt: card line {first} {card[first:first + 1]} "
                                 f"!= CPU {cpu[first:first + 1]}")
        logmel.logmel_launches = 0
        out = _run_cli(["stream", "--wav", wav, "--chunk-seconds", "1.0",
                        "--quantization", "none"] + common)
        stream_launches = logmel.logmel_launches
        sessions = [ln for ln in out.splitlines() if ln.startswith("session:")]
        if len(sessions) != 1 or stream_launches == 0 or launches == 0:
            raise AssertionError(f"cli stream: {sessions}, K1 launches {stream_launches}")
    print(f"cli transcribe: golden clip 0 on the card, {len(texts)} segments, the first 8 the "
          f"golden text {golden_text!r}; srt card == CPU ({len(srt['cuda'].encode())} bytes); "
          f"K1 launches {launches}")
    print(f"cli stream --wav: {sessions[0]}; K1 launches {stream_launches}")
    return launches + stream_launches


#: the full-width training cell: large-v3 f32 from seed 0, the 16 s bucket,
#: 2 rows, the 64-token bucket, 1 warm-up + 3 timed steps on one batch
TRAIN_STEPS = 4
TRAIN_CLIPS = ((12.0, 45), (14.5, 50))


def _recipe(lr: float, warmup: int):
    """tools/finetune.py's optimizer (decay over 10,000 steps)."""
    from realtime_whisper_asr_tpu_torch.train import optim as O

    return O.chain(O.clip_by_global_norm(1.0),
                   O.adamw(O.warmup_cosine_decay_schedule(0.0, lr, warmup, 10_000),
                           weight_decay=0.01))


def check_optimizer_card_equals_cpu() -> None:
    """The finetune recipe's optimizer (``train/optim.py``) on the card
    against the CPU, on identical leaves (large-v3 shapes) and gradients:
    3 steps with the clip keeping the gradients (norm under 1), parameters
    bit for bit; then the global norm of gradients above 1, card vs CPU,
    within 1 ulp (both sum in f64, each in its own order)."""
    import torch

    from realtime_whisper_asr_tpu_torch.train import optim as O

    rng = np.random.default_rng(0)
    shapes = {"fc1.weight": (5120, 1280), "fc1.bias": (5120,), "ln.weight": (1280,),
              "conv.weight": (1280, 128, 3)}
    init = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    params = {dev: {k: torch.from_numpy(v).to(dev) for k, v in init.items()}
              for dev in ("cuda", "cpu")}
    opts = {dev: _recipe(1e-3, 1) for dev in params}
    states = {dev: opts[dev].init(params[dev]) for dev in params}
    for _ in range(3):
        grads = {k: (rng.standard_normal(v) * 1e-4).astype(np.float32)
                 for k, v in shapes.items()}
        for dev in params:
            u, states[dev] = opts[dev].update({k: torch.from_numpy(g).to(dev)
                                               for k, g in grads.items()},
                                              states[dev], params[dev])
            O.apply_updates(params[dev], u)
    unequal = [k for k in shapes if not torch.equal(params["cuda"][k].cpu(), params["cpu"][k])]
    big = {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32)) for k, v in shapes.items()}
    norms = [O.global_norm({k: v.to(dev) for k, v in big.items()}).cpu().numpy()
             for dev in ("cuda", "cpu")]
    ulps = abs(int(norms[0].view(np.int32)) - int(norms[1].view(np.int32)))
    print(f"optimizer card vs CPU: 3 recipe steps on {sum(map(np.prod, shapes.values())):,} "
          f"parameters, {len(shapes) - len(unequal)} of {len(shapes)} leaves bit-equal; global "
          f"norm {float(norms[0]):.7g} vs {float(norms[1]):.7g} ({ulps} ulp)")
    if unequal or ulps > 1:
        raise AssertionError(f"optimizer card vs CPU: {unequal} differ, norm {ulps} ulp apart")


def _train_tiny(d: str) -> int:
    """Three finetune steps of the golden test-tiny weights on the card
    against the same three on the CPU (the CPU tests' tolerances), K1 of a
    batch against the plain version on the card, and a save / load /
    continue on the card bit-equal to the uninterrupted run. Returns K1's
    launches of the card's runs."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
        load_train_state,
        save_train_state,
    )
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.tools.finetune import finetune, parse_args
    from realtime_whisper_asr_tpu_torch.train import optim as O
    from realtime_whisper_asr_tpu_torch.train.data import DataPipeline, prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import make_train_state, make_train_step

    cfg = get_config("test-tiny")
    ckpt = golden_checkpoint(os.path.join(d, "ckpt"))
    man = write_manifest(d, [(1.0 + 0.25 * i, 3 + i) for i in range(6)])
    lr, warmup = 1e-3, 1
    runs, launches = {}, 0
    for dev in ("cuda", "cpu"):
        logmel.logmel_launches = 0
        runs[dev] = finetune(parse_args([
            "--manifest", man, "--init-checkpoint", ckpt, "--out", os.path.join(d, dev),
            "--batch-size", "2", "--lr", str(lr), "--warmup-steps", str(warmup),
            "--save-every", "0", "--log-every", "10"] + (["--cpu"] if dev == "cpu" else [])))
        launches += logmel.logmel_launches if dev == "cuda" else 0
    card, cpu = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    schedule = O.warmup_cosine_decay_schedule(0.0, lr, warmup, 10_000)
    lr_sum = sum(schedule(c) for c in range(card["steps"]))
    off, worst = 0, 0.0
    for k, v in card["state"].params.items():
        diff = (v.detach().cpu() - cpu["state"].params[k].detach()).abs()
        off += int((diff > 1e-6).sum())
        worst = max(worst, float(diff.max()))
    if (card["steps"] != 3 or cpu["steps"] != 3 or rel > 1e-4 or off > 4
            or worst > 2 * lr_sum + 1e-6):
        raise AssertionError(f"train test-tiny card vs CPU: losses {card['losses']} / "
                             f"{cpu['losses']}, {off} elements above 1e-6, largest {worst:.3g}")
    print(f"train test-tiny f32, 3 finetune steps (golden weights, lr {lr}, warm-up {warmup}): "
          f"losses card {[round(x, 6) for x in card['losses']]} CPU "
          f"{[round(x, 6) for x in cpu['losses']]} (max rel {rel:.3g}, tolerance 1e-4); params "
          f"max |card - CPU| {worst:.3g}, {off} elements above 1e-6 (tolerance: 4, each within "
          f"2·Σlr = {2 * lr_sum:.3g}); K1 launches {launches}")

    batches = list(DataPipeline(man, cfg, MockTokenizer(cfg), batch_size=2, seed=0).epochs(1))
    b = prepare_batch(batches[0], cfg, "cuda")
    plain = torch.stack([logmel.log_mel_spectrogram_plain(torch.from_numpy(a).cuda(), cfg.n_mels)
                         for a in batches[0]["audio"]])
    mel, ref = b["mel"].cpu().numpy(), plain.cpu().numpy()
    for row in range(len(mel)):
        check_logmel_close(mel[row], ref[row], f"train batch K1 vs plain, row {row}")
    print(f"train batch K1 vs plain on the card: {mel.shape}, max |Δ| "
          f"{float(np.abs(mel - ref).max()):.3g} (K1's tolerance)")

    opt = _recipe(lr, warmup)
    step, _ = make_train_step(cfg, opt, "cuda")
    logmel.logmel_launches = 0
    prepared = [prepare_batch(x, cfg, "cuda") for x in batches]
    launches += logmel.logmel_launches

    def fresh():
        return make_train_state(cfg, torch.Generator("cuda").manual_seed(0), opt, device="cuda")[0]

    straight = fresh()
    for x in prepared:
        straight, _ = step(straight, x)
    state = fresh()
    for x in prepared[:2]:
        state, _ = step(state, x)
    save_train_state(os.path.join(d, "ts"), state)
    resumed, _ = step(load_train_state(os.path.join(d, "ts"), fresh()), prepared[2])
    unequal = [k for k, v in straight.params.items() if not torch.equal(v, resumed.params[k])]
    if unequal or resumed.step != 3:
        raise AssertionError(f"train resume on the card: {len(unequal)} tensors differ "
                             f"({unequal[:3]}), step {resumed.step}")
    print(f"train resume on the card: 2 steps, save, load, 1 step == 3 steps, all "
          f"{len(straight.params)} tensors bit-equal")
    return launches


def profile_train_step(state, opt, cfg, batch: dict, step_s: float) -> dict:
    """One more step of the cell, its parts timed by CUDA events (the
    batch's log-mel, forward + backward, the optimizer) and traced: kernel
    ms by kind (GEMM: cuBLAS and CUTLASS kernels; the rest), the card's busy
    share of the step's wall time and the top kernels."""
    import torch

    from realtime_whisper_asr_tpu_torch.train import optim as O
    from realtime_whisper_asr_tpu_torch.train.data import prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import loss_and_grads

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        ev[0].record()
        b = prepare_batch(batch, cfg, "cuda")
        ev[1].record()
        _, grads = loss_and_grads(state.params, cfg, b)
        ev[2].record()
        updates, _ = opt.update(grads, state.opt_state, state.params)
        O.apply_updates(state.params, updates)
        ev[3].record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    parts = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
             enumerate(("log-mel ms", "forward+backward ms", "optimizer ms"))}
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return dict(parts, kernels="not measured (no kernels traced)")
    total = sum(e.self_device_time_total for e in events) / 1e3
    gemm = sum(e.self_device_time_total for e in events
               if any(w in e.key.lower() for w in ("gemm", "cutlass", "xmma"))) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return dict(parts, **{
        "kernels ms": total, "GEMM ms": gemm, "GEMM share": f"{gemm / total:.0%}",
        "busy": f"{total / 1e3 / wall:.0%} of {wall:.3f} s traced ({step_s:.3f} s untraced)",
        "top": ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms" for e in top)})


def phase_train(smi: str) -> int:
    """The optimizer card vs CPU, the training path on the card
    (``_train_tiny``), then the full-width
    cell: large-v3 f32 from seed 0, 2 rows of the 16 s bucket with the
    64-token bucket, the finetune recipe (lr 1e-4, no warm-up, so step 1
    trains), 1 warm-up step and 3 timed ones on the same batch, each step's
    batch through ``prepare_batch`` (2 K1 launches). Prints the loss per
    step (near ln 51,866 at random weights, falling), seconds a step, tokens
    a second, the hand-counted FLOPs a step over the f32 peak, peak memory
    beside the prediction, K1's launches (= 2 a step), then one profiled
    step's split (``profile_train_step``). Returns K1's launches on the
    training path."""
    import gc
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.train.data import DataPipeline, prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import (
        make_train_state,
        make_train_step,
        step_flops,
    )

    check_optimizer_card_equals_cpu()
    with tempfile.TemporaryDirectory() as d:
        launches = _train_tiny(d)
        cfg = get_config("large-v3")
        man = write_manifest(d, list(TRAIN_CLIPS))
        (batch,) = DataPipeline(man, cfg, MockTokenizer(cfg), batch_size=2, seed=0).epochs(1)
    b, n = batch["audio"].shape
    s = batch["tokens_in"].shape[1]
    if (b, n, s) != (2, 16 * SR, 64):
        raise AssertionError(f"train cell batch {batch['audio'].shape}, {s} tokens")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt = _recipe(1e-4, 0)
    state, opt = make_train_state(cfg, torch.Generator("cuda").manual_seed(0), opt, device="cuda")
    step, _ = make_train_step(cfg, opt, "cuda")
    n_params = sum(v.numel() for v in state.params.values())
    logmel.logmel_launches = 0
    losses, seconds = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, prepare_batch(batch, cfg, "cuda"))
        losses.append(float(loss))  # reads the loss: waits for the step
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    split = profile_train_step(state, opt, cfg, batch, sum(seconds[1:]) / (TRAIN_STEPS - 1))
    k1 = logmel.logmel_launches
    launches += k1
    del state, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    flops = step_flops(cfg, b, n // 160, s)
    sec = float(np.median(seconds[1:]))
    state_gb = 4 * 4 * n_params / 1e9
    print(f"train large-v3 f32 (seed 0, {n_params:,} parameters), batch {b} x 16 s x {s} tokens, "
          f"lr 1e-4: losses {[round(x, 4) for x in losses]} (ln 51866 = {math.log(51866):.4f}); "
          f"step s {[round(x, 4) for x in seconds]}, timed median {sec:.4f} s; "
          f"{b * s / sec:.1f} tokens/s ({int(batch['mask'].sum())} supervised a step), "
          f"{b * 16 / sec:.2f} audio s/s; {flops / 1e12:.3f} TFLOP a step (hand count, 4 "
          f"forwards) = {flops / sec / 1e12:.2f} TFLOP/s, {100 * flops / sec / PEAK_F32_FLOPS:.1f} "
          f"% of the f32 peak 67 TFLOP/s; peak memory {peak / 1e9:.2f} GB above the start "
          f"(predicted: params, grads, 2 moments 4 x {state_gb / 4:.2f} = {state_gb:.1f} GB + "
          f"~5 GB of recomputed activations a row = ~{state_gb + 5 * b:.0f} GB); K1 launches "
          f"{k1} (predicted {2 * (TRAIN_STEPS + 1)}, 2 a step with the profiled one); {smi}")
    if split:
        print("train large-v3 step split: " + "; ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}" for k, v in split.items()))
    if (k1 != 2 * (TRAIN_STEPS + 1) or not all(math.isfinite(x) for x in losses)
            or abs(losses[0] - math.log(51866)) > 1.0 or not losses[-1] < losses[0]):
        raise AssertionError(f"train large-v3: losses {losses}, K1 launches {k1}")
    return launches


def phase_train_vad() -> None:
    """``tools/train_vad.py``'s loop: the first step's loss on the card
    against the CPU's from the same seeded init and batch, then 20 steps on
    the card at the tool's defaults (16 x 4 s, lr 2e-3): the loss falls."""
    from realtime_whisper_asr_tpu_torch.models.vad.silero_like import SileroLikeNet
    from realtime_whisper_asr_tpu_torch.tools import train_vad

    first = train_vad.train(SileroLikeNet("cpu", seed=0), 1, 16, 4.0, 2e-3, 0)
    t0 = time.perf_counter()
    card = train_vad.train(SileroLikeNet("cuda", seed=0), 20, 16, 4.0, 2e-3, 0, log_every=10)
    sec = time.perf_counter() - t0
    rel = abs(card[0] - first[0]) / abs(first[0])
    print(f"train_vad: 20 steps on the card, losses {card[0]:.5f} -> {card[-1]:.5f} "
          f"(min {min(card):.5f}); first step card vs CPU {card[0]:.7f} / {first[0]:.7f} "
          f"(rel {rel:.3g}, tolerance 1e-5); {sec / 20 * 1e3:.1f} ms a step with the host's "
          f"batch synthesis")
    if rel > 1e-5 or not card[-1] < card[0]:
        raise AssertionError(f"train_vad: card {card}, CPU first step {first}")


#: phase_tools' cuts: the speaker corpus (the tool's: 160 speakers x 5
#: utterances), the steps, the drill's decodes (random weights never emit
#: EOT), the soak passes (the full-width one; the tool's default at test-tiny)
SPEAKER_CORPUS = (40, 5)
SPEAKER_STEPS = 100
SEPARATOR_STEPS = 20
DRILL_TOKENS = 32
SOAK_FULL_MINUTES = 3
SOAK_TINY_MINUTES = 10


def _wall_ms(fn, reps: int) -> float:
    """Host ms a call of fn(), the card synchronized after the calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _tools_speaker(smi: str) -> None:
    """``tools/train_speaker.py`` on the card: the first step against the
    CPU's from ``init_speaker_params(0)`` on the same minibatch (loss within
    1e-5 relative), then ``SPEAKER_STEPS`` steps at the tool's batch (24
    speakers x 2 utterances, lr 3e-4) over a corpus cut to
    ``SPEAKER_CORPUS``: the loss falls; ms a step with and without the
    host's minibatch."""
    import torch

    from realtime_whisper_asr_tpu_torch.tools import train_speaker as TS
    from realtime_whisper_asr_tpu_torch.train import optim as O

    t0 = time.perf_counter()
    corpus = TS.make_corpus(np.random.default_rng(0), *SPEAKER_CORPUS)
    synth_s = time.perf_counter() - t0
    x, y = TS.minibatch(np.random.default_rng(1), corpus, 24, 2)
    first = {}
    for dev in ("cpu", "cuda"):
        params, opt = TS.init_params(0, dev), O.adam(3e-4)
        _, loss = TS.make_train_step(opt, 0.1, dev)(
            params, opt.init(params), torch.from_numpy(x).to(dev),
            torch.from_numpy(y).long().to(dev))
        first[dev] = float(loss)
    rel = abs(first["cuda"] - first["cpu"]) / abs(first["cpu"])
    t0 = time.perf_counter()
    _, losses = TS.train(corpus, np.random.default_rng(2), SPEAKER_STEPS, 24, 2, 3e-4, 0.1, 0,
                         "cuda", log_every=SPEAKER_STEPS)
    with_host = 1e3 * (time.perf_counter() - t0) / SPEAKER_STEPS
    params, opt = TS.init_params(0, "cuda"), O.adam(3e-4)
    state = [opt.init(params)]
    step = TS.make_train_step(opt, 0.1, "cuda")
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).long().cuda()
    device_only = _wall_ms(lambda: state.__setitem__(0, step(params, state[0], xd, yd)[0]), 50)
    early, late = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"tools train_speaker on {smi}: first step card vs CPU {first['cuda']:.7f} / "
          f"{first['cpu']:.7f} (rel {rel:.3g}, tolerance 1e-5); {SPEAKER_STEPS} steps at 24 x 2, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first / last 10: "
          f"{early:.4f} / {late:.4f}); {with_host:.2f} ms a step with the host's minibatch, "
          f"{device_only:.2f} ms without; corpus {len(corpus['x'])} utterances "
          f"({SPEAKER_CORPUS[0]} speakers; the tool's 160) synthesised in {synth_s:.1f} s")
    if rel > 1e-5 or not late < early:
        raise AssertionError(f"train_speaker: first step {first}, losses {losses}")


def _tools_separator(smi: str) -> None:
    """``tools/train_separator.py`` on the card at the tool's defaults (v2,
    batch 8 x 16,384 samples, lr 1e-3 over 2,500 steps): from one JAX-layout
    checkpoint (``save_ckpt`` of a seeded init), the first step on the card
    against the CPU's (loss within 1e-5 relative, every parameter within
    1e-5 of its scale), then ``SEPARATOR_STEPS`` steps whose loss falls; ms
    of the device step alone and of the host's ``make_batch``, the step's
    peak memory; one ``v2x4`` step card vs CPU."""
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.models import separation_nn as S
    from realtime_whisper_asr_tpu_torch.tools import train_separator as TP

    def compare(label: str, ckpt: str) -> int:
        """The first step at batch 8 on the card and the CPU from ``ckpt``:
        the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
        scale (what two f32 backwards' sums over a conv's ~266,000 positions
        keep; ``tests/test_torch_train_separator.py``), and every parameter
        after the step within 1e-5 of its scale of the CPU's plus what the
        two gradients part Adam's first update ``lr·g/(|g| + 1e-8)`` by
        there (an element of a near-zero gradient is divided by its own
        size, so a gradient difference within the tolerance above moves it
        by up to 2·lr). A failure raises -> the card step's peak bytes."""
        from realtime_whisper_asr_tpu_torch.device import exact_kernels

        opt = TP.make_optimizer(1e-3, 2500)
        params, state, _, rng = TP.load_ckpt(ckpt, opt, "cpu")
        mix, clean = TP.next_batch(rng, S.n_stems_of(params), 8, 0.0)
        loss, grads, got = {}, {}, {}
        for dev in ("cpu", "cuda"):
            opt = TP.make_optimizer(1e-3, 2500)
            params, state, _, _ = TP.load_ckpt(ckpt, opt, dev)
            dil = S.arch_of(params)[0]
            m, c = torch.from_numpy(mix).to(dev), torch.from_numpy(clean).to(dev)
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            with exact_kernels():
                g = torch.autograd.grad(TP.loss_fn(leaves, m, c, dil), list(leaves.values()))
            grads[dev] = {k: v.cpu() for k, v in zip(leaves, g)}
            step = TP.make_train_step(opt, dil)

            def run():
                loss[dev] = float(step(params, state, m, c)[1])

            peak = _peak_bytes(run) if dev == "cuda" else run()
            got[dev] = {k: v.cpu() for k, v in params.items()}
        rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        g_err = max((float((grads["cuda"][k] - grads["cpu"][k]).abs().max())
                     / float(grads["cpu"][k].abs().max()), k) for k in grads["cpu"])
        def first_update(g):
            return 1e-3 * g.double() / (g.double().abs() + 1e-8)

        worst, moved, off = 0.0, 0, []
        for k, ref in got["cpu"].items():
            diff = (got["cuda"][k] - ref).abs().double()
            scale = float(ref.abs().max())
            worst = max(worst, float(diff.max()) / scale)
            moved += int((diff > 1e-5 * scale).sum())
            parted = (first_update(grads["cuda"][k]) - first_update(grads["cpu"][k])).abs()
            if bool((diff > parted + 1e-5 * scale).any()):
                off.append(k)
        print(f"tools train_separator {label}: first step card vs CPU, loss {loss['cuda']:.7f} / "
              f"{loss['cpu']:.7f} (rel {rel:.3g}, tolerance 1e-5); gradients within "
              f"{g_err[0]:.3g} of their scale ({g_err[1]}; tolerance 1e-4); parameters within "
              f"{worst:.3g} of their scale, {moved} elements above 1e-5, each within 1e-5 + "
              f"the first update's difference for the two gradients")
        if rel > 1e-5 or g_err[0] > 1e-4 or off:
            raise AssertionError(f"train_separator {label}: the card's first step is not the "
                                 f"CPU's ({off})")
        return peak

    with tempfile.TemporaryDirectory() as d:
        for arch in ("v2", "v2x4"):
            params = TP.init_params(arch, 0, "cpu")
            opt = TP.make_optimizer(1e-3, 2500)
            TP.save_ckpt(os.path.join(d, arch + ".npz"), params, opt.init(params), 0,
                         np.random.default_rng(0))
        peak = compare("v2 (batch 8)", os.path.join(d, "v2.npz"))
        compare("v2x4 (batch 8)", os.path.join(d, "v2x4.npz"))
        opt = TP.make_optimizer(1e-3, 2500)
        params, state, start, rng = TP.load_ckpt(os.path.join(d, "v2.npz"), opt, "cuda")
    t0 = time.perf_counter()
    _, losses = TP.train(params, opt, state, rng, start, SEPARATOR_STEPS, 8,
                         log_every=SEPARATOR_STEPS)
    train_ms = 1e3 * (time.perf_counter() - t0) / SEPARATOR_STEPS
    brng = np.random.default_rng(5)
    t0 = time.perf_counter()
    mix, clean = TP.make_batch(brng, 8)
    for _ in range(4):
        TP.make_batch(brng, 8)
    batch_ms = 1e3 * (time.perf_counter() - t0) / 5
    step = TP.make_train_step(opt, S.arch_of(params)[0])
    holder = [state]
    mix, clean = torch.from_numpy(mix).cuda(), torch.from_numpy(clean).cuda()
    step_ms = _wall_ms(lambda: holder.__setitem__(0, step(params, holder[0], mix, clean)[0]), 10)
    early, late = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"tools train_separator v2 on {smi}: {SEPARATOR_STEPS} steps at batch 8, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} (mean of the first / last 5: {early:.5f} / "
          f"{late:.5f}); {train_ms:.1f} ms a step in the tool's loop, of which make_batch on "
          f"the host {batch_ms:.1f} ms and the device step alone {step_ms:.2f} ms (host clock, "
          f"synchronized); the step's peak {peak / 2**20:.1f} MiB above the parameters and "
          f"the optimizer's state")
    if not late < early:
        raise AssertionError(f"train_separator: losses {losses}")


def _tools_calibrate() -> None:
    """``tools/calibrate.py --synth`` at the tool's default corpus (12 VAD
    clips, 6 speakers x 3 utterances, 12 dedup pairs): the card's JSON equals
    the ``--cpu`` run's."""
    import io
    import tempfile

    from realtime_whisper_asr_tpu_torch.tools import calibrate

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for dev, extra in (("cuda", []), ("cpu", ["--cpu"])):
            path = os.path.join(d, f"{dev}.json")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = calibrate.main([os.path.join(d, dev), "--synth", "--out", path] + extra)
            if rc != 0:
                raise AssertionError(f"calibrate on {dev} exited {rc}")
            with open(path) as f:
                out[dev] = json.load(f)
    print(f"tools calibrate --synth: card == CPU {out['cuda'] == out['cpu']}; thresholds: VAD "
          f"{out['cuda']['vad']['threshold']} (AUC {out['cuda']['vad']['auc']}), speaker "
          f"{out['cuda']['speaker']['threshold']} (EER {out['cuda']['speaker']['eer']}), dedup "
          f"{out['cuda']['dedup']['similarity_threshold']} / "
          f"{out['cuda']['dedup']['duplicate_threshold']}")
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"calibrate: card {out['cuda']} != CPU {out['cpu']}")


@contextlib.contextmanager
def _token_cap(n: int):
    """Every ``TorchWhisperASR`` built inside caps its windows at ``n`` tokens."""
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR

    init = TorchWhisperASR.__init__

    def capped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.transcribe_kargs.update(max_new_tokens=n, max_total_tokens=n)

    TorchWhisperASR.__init__ = capped
    try:
        yield
    finally:
        TorchWhisperASR.__init__ = init


def _tools_drill() -> int:
    """``tools/checkpoint_drill.py`` on the golden test-tiny weights written
    as an HF directory in bf16 (``write_hf_dir``; the drill's conversion
    stores bf16, so the weights are bf16-exact from the start), its ASRs at
    f32 with ``DRILL_TOKENS``-token caps: every step ok on the card, and its
    decoded tokens equal to the CPU drill's. -> K1's launches on the card."""
    import io
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.tools import checkpoint_drill

    cfg = get_config("test-tiny")
    state = {k: v.to(torch.bfloat16)
             for k, v in load_flat_npz(os.path.join(GOLDEN, "params.npz")).items()}
    runs = {}
    with tempfile.TemporaryDirectory() as d, _token_cap(DRILL_TOKENS):
        hf = os.path.join(d, "hf")
        write_hf_dir(hf, cfg, state, checkpoint_heads(cfg))
        for dev in ("cuda", "cpu"):
            logmel.logmel_launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                runs[dev] = checkpoint_drill.run_drill(hf, os.path.join(d, dev), device=dev,
                                                       dtype=torch.float32)
            if dev == "cuda":
                launches = logmel.logmel_launches
    (card, card_tokens), (cpu, cpu_tokens) = runs["cuda"], runs["cpu"]
    flags = {k: v["ok"] for k, v in card["steps"].items()}
    print(f"tools checkpoint_drill (golden test-tiny, bf16 HF dir, f32, {DRILL_TOKENS}-token "
          f"caps): card steps {flags}, s {[v['seconds'] for v in card['steps'].values()]}; "
          f"tokens card == CPU {card_tokens == cpu_tokens} ({[len(t) for t in card_tokens]}); "
          f"K1 launches {launches}")
    if not card["ok"] or not cpu["ok"] or card_tokens != cpu_tokens or not launches:
        raise AssertionError(f"checkpoint_drill: card {card} tokens {card_tokens}, CPU {cpu} "
                             f"tokens {cpu_tokens}")
    return launches


def _soak_pass(label: str, smi: str, minutes: float, model: str,
               config: dict | None) -> tuple[int, str]:
    """One ``run_soak`` on the card with the ticks' host ms, the card's
    memory after the warm-up decile and the rows each ``_encode_many``
    encoded recorded around it: it must be ok, and K1's launches equal the
    windows encoded -> (K1's launches, the tier the app ran)."""
    import gc

    import torch

    from realtime_whisper_asr_tpu_torch.app import StreamingApp
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.tools import soak

    n_ticks = int(minutes * 60)
    ticks, rows, seen = [], [0], {}
    process_chunk, encode_many = StreamingApp.process_chunk, TorchWhisperASR._encode_many

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = process_chunk(self, *args, **kwargs)
        ticks.append(1e3 * (time.perf_counter() - t0))
        if len(ticks) == n_ticks // 10 + 1:  # the soak's warm-up decile ends here
            torch.cuda.synchronize()
            seen["warm"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        seen["tier"] = self.asr.quantization
        seen["captures"] = self.asr.decode_loop.stats["captures"]
        return out

    def counted(self, keys, n_samples_list):
        rows[0] += len(keys)
        return encode_many(self, keys, n_samples_list)

    StreamingApp.process_chunk, TorchWhisperASR._encode_many = timed, counted
    logmel.logmel_launches = 0
    try:
        report = soak.run_soak(minutes, model=model, device="cuda", config=config)
    finally:
        StreamingApp.process_chunk, TorchWhisperASR._encode_many = process_chunk, encode_many
    gc.collect()  # the session's app and ASR, freed
    torch.cuda.synchronize()
    launches = logmel.logmel_launches
    growth = torch.cuda.max_memory_allocated() - seen["warm"]
    after = torch.cuda.memory_allocated() - seen["warm"]
    dec = max(len(ticks) // 10, 1)
    second, last = np.asarray(ticks[dec:2 * dec]), np.asarray(ticks[-dec:])
    print(f"tools soak {label} on {smi}: ok {report['ok']} {report['failures']}; tier "
          f"{seen['tier']}; {report['ticks']} ticks of 1 s in {report['wall_seconds']} s (soak "
          f"RTF {report['soak_rtf']}); tick p50/p95 second decile {np.median(second):.2f} / "
          f"{np.percentile(second, 95):.2f} ms, last decile {np.median(last):.2f} / "
          f"{np.percentile(last, 95):.2f} ms; graph_keys {report['graph_keys']}, recaptures "
          f"after the warm-up {report['recaptures']}, captures {seen['captures']}; RSS growth "
          f"{report['rss_mb_growth_after_warmup']} MB; the card's peak above the allocated at "
          f"the warm-up's end {growth / 2**20:.1f} MiB, allocated after the session "
          f"{after / 2**20:+.1f} MiB of it; audio buffer max {report['audio_buffer_s_max']} s, "
          f"results {report['results']}; K1 launches {launches} = windows encoded {rows[0]}")
    if not report["ok"] or launches != rows[0] or not launches:
        raise AssertionError(f"soak {label}: {report}; K1 {launches} for {rows[0]} windows")
    return launches, seen["tier"]


def _tools_soak(smi: str) -> int:
    """``tools/soak.py`` on the card: large-v3 ``int8-all`` at full width
    (random weights from seed 0, ``phase_app``'s scenario-5 keys through the
    soak's ``config``) for ``SOAK_FULL_MINUTES`` simulated minutes, then the
    tool's default (test-tiny, 10 minutes); both ok, K1 launches = windows
    encoded. -> K1's launches."""
    import gc

    full, tier = _soak_pass("large-v3 int8-all", smi, SOAK_FULL_MINUTES, "large-v3",
                            {**APP_SCENARIO5, "model.max_tokens_per_second": 4.0})
    if tier != "int8-all":
        raise AssertionError(f"soak large-v3: the app ran {tier}, not int8-all")
    gc.collect()
    empty_device_cache("cuda")
    tiny, _ = _soak_pass("test-tiny (the tool's default)", smi, SOAK_TINY_MINUTES, "test-tiny",
                         None)
    return full + tiny


def _tools_example() -> int:
    """``examples/offline_transcribe.py`` on golden clip 0 through a native
    checkpoint of the golden weights, on the card at f32: its lines carry the
    golden row's text. -> K1's launches."""
    import io
    import tempfile

    from realtime_whisper_asr_tpu_torch.examples import offline_transcribe
    from realtime_whisper_asr_tpu_torch.io import write_wav
    from realtime_whisper_asr_tpu_torch.ops import logmel

    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        golden_text = json.load(f)["clips"][0]["offline_text"]
    with tempfile.TemporaryDirectory() as d:
        ckpt = golden_checkpoint(os.path.join(d, "ckpt"))
        wav = os.path.join(d, "golden0.wav")
        write_wav(wav, golden_audio(0))
        buf = io.StringIO()
        logmel.logmel_launches = 0
        with contextlib.redirect_stdout(buf):
            rc = offline_transcribe.main([wav, "--checkpoint", ckpt, "--dtype", "float32"])
        launches = logmel.logmel_launches
    texts = [ln.split("] ", 1)[1] for ln in buf.getvalue().splitlines() if "-->" in ln]
    print(f"tools example offline_transcribe: golden clip 0 on the card, {len(texts)} segments, "
          f"the first 8 the golden text {''.join(texts[:8]) == golden_text}; K1 launches "
          f"{launches}")
    if rc != 0 or "".join(texts[:8]) != golden_text or not launches:
        raise AssertionError(f"offline_transcribe: {texts[:8]} is not {golden_text!r}")
    return launches


def phase_tools(smi: str) -> int:
    """The offline tools and the examples on the card: the speaker and
    separator trainers, calibration, the checkpoint drill, the soak and
    ``offline_transcribe``. -> K1's launches (the drill's, the soaks', the
    example's)."""
    _tools_speaker(smi)
    _tools_separator(smi)
    _tools_calibrate()
    return _tools_drill() + _tools_soak(smi) + _tools_example()


def _parallel_decode(smi: str, model_size: str, device: str, mesh, d: str) -> int:
    """The tensor-parallel decode at 1 rank: the unsharded ASR's
    ``int8-all`` model saved in the native format, read back by
    ``load_checkpoint_sharded`` (bit-equal to ``load_checkpoint``), built by
    ``shard_model``; one 16 s window's K1 mel encoded by both, the prefill
    logits and the decode (graphs on the card, NCCL captured in them)
    bit-equal. Returns K1's launches."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
        load_checkpoint,
        load_checkpoint_sharded,
        save_checkpoint,
    )
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.parallel import shard_model

    asr = TorchWhisperASR(model_size=model_size, dtype=torch.bfloat16, device=device, seed=0,
                          quantization="int8-all")
    cfg = asr.model.cfg
    ckpt = os.path.join(d, "int8-all")
    nbytes = save_checkpoint(ckpt, asr.model.state_dict(), cfg)
    t0 = time.perf_counter()
    _, local = load_checkpoint_sharded(ckpt, mesh)
    load_s = time.perf_counter() - t0
    _, whole = load_checkpoint(ckpt)
    unequal = [k for k in whole if not torch.equal(whole[k], local[k])]
    read = sum(t.numel() * t.element_size() for t in local.values())
    if unequal or local.keys() != whole.keys():
        raise AssertionError(f"load_checkpoint_sharded at 1 x 1: {unequal[:3]} differ")
    print(f"parallel: load_checkpoint_sharded of {model_size} int8-all (native, "
          f"{nbytes / 1e9:.3f} GB file) at mesh {mesh.shape}: {len(local)} tensors bit-equal to "
          f"load_checkpoint, {read / 1e9:.3f} GB copied in {load_s:.2f} s")
    tp = shard_model(local, cfg, mesh, dtype=torch.bfloat16, local=True)
    del local, whole

    opts = dataclasses.replace(asr._make_opts(), max_new_tokens=32, max_total_tokens=32)
    plan = D.plan_window(cfg, opts)
    aux = torch.from_numpy(plan.aux).to(device)[None]
    logmel.logmel_launches = 0
    with torch.inference_mode():
        mel = logmel.log_mel_spectrogram(torch.from_numpy(speechy_audio(16.0)).to(device),
                                         n_mels=cfg.n_mels)[None]
    launches = logmel.logmel_launches
    captured = torch_device(device).type == "cuda"
    got = {}
    for name, model in (("unsharded", asr.model), ("tp", tp)):
        loop = D.DecodeLoop()
        with torch.inference_mode():
            xa = model.encode(mel.to(model.dtype))
            cache = model.init_cache(xa)
            init = torch.from_numpy(plan.init[None].astype(np.int64)).to(device)
            pre, _ = model.decode_span(init, 0, cache)
            packed = D._decode_window(model, opts, xa, aux, plan, asr._extra_suppress, None,
                                      loop, captured=captured)
        step = graph_step_ms(loop)[1] if captured else None
        got[name] = (pre.cpu(), packed.cpu(), loop.stats, step)
    (pre1, packed1, stats1, ms1), (pre2, packed2, stats2, ms2) = got["unsharded"], got["tp"]
    if not (torch.equal(pre1, pre2) and torch.equal(packed1.view(torch.int32),
                                                     packed2.view(torch.int32))):
        raise AssertionError(f"parallel tp decode: prefill logits equal {torch.equal(pre1, pre2)}, "
                             f"tokens {packed1[:plan.max_new].tolist()} vs "
                             f"{packed2[:plan.max_new].tolist()}")
    tokens = [int(t) for t in packed2[: plan.max_new]]
    ms = "not measured (no card)" if ms1 is None else f"{ms2:.3f} vs {ms1:.3f} unsharded"
    print(f"parallel: tp decode of {model_size} int8-all at mesh {mesh.shape}, 16 s window, "
          f"32-token cap: prefill logits {tuple(pre2.shape)} and the packed result bit-equal "
          f"to the unsharded port ({len(tokens)} token slots); captures {stats2['captures']} "
          f"(unsharded {stats1['captures']}), replays {stats2['replays']}; kernel ms a step "
          f"{ms}; K1 launches {launches}; {smi}")
    return launches


def _train_runs(model_size: str, device: str, mesh, pp_mesh) -> int:
    """``phase_train``'s full-width cell at 1 x 1: two steps of ``make_train_step``
    (the reference), of ``make_sharded_train_step`` and of it with
    ``sequence_parallel``, each from the seeded init, the sharded ones
    bit-equal to the reference in the losses and every parameter; one
    ``make_pp_train_step`` step at one stage and 2 microbatches, its loss
    within 1e-5 relative of the reference's first. Returns K1's launches."""
    import gc
    import tempfile

    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.parallel import (
        data_sharding,
        make_pp_train_state,
        make_pp_train_step,
    )
    from realtime_whisper_asr_tpu_torch.train.data import DataPipeline, prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import (
        make_sharded_train_step,
        make_train_state,
        make_train_step,
    )

    cfg = get_config(model_size)
    with tempfile.TemporaryDirectory() as d:
        man = write_manifest(d, list(TRAIN_CLIPS))
        (batch,) = DataPipeline(man, cfg, MockTokenizer(cfg), batch_size=2, seed=0).epochs(1)
    is_cuda = torch_device(device).type == "cuda"
    ref: dict = {}

    def run(name, steps, make):
        """``steps`` steps from the seeded init; the first run's parameters
        are kept as the reference, each later run's compared with them on
        the device. Returns (name, losses, s a step, peak GB above the
        start, the tensors that differ)."""
        gc.collect()
        empty_device_cache(device)
        start = torch.cuda.memory_allocated() if is_cuda else 0
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        opt = _recipe(1e-4, 0)
        state, step, shard_fn = make(opt, torch.Generator(device).manual_seed(0))
        losses, secs = [], []
        for _ in range(steps):
            sync_device(device)
            t0 = time.perf_counter()
            state, loss = step(state, prepare_batch(batch, cfg, device, shard_fn=shard_fn))
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - start) / 1e9 if is_cuda else float("nan")
        if not ref:
            ref.update({k: v.detach() for k, v in state.params.items()})
        unequal = [k for k in ref if not torch.equal(ref[k], state.params[k])]
        worst = max((float((ref[k] - state.params[k]).abs().max()), k) for k in unequal) \
            if unequal else None
        print(f"parallel train {model_size} f32, batch 2 x 16 s x 64 tokens at mesh "
              f"{mesh.shape}: {name}: losses {losses}, s a step {[round(s, 4) for s in secs]}, "
              f"peak memory {peak:.2f} GB above the start")
        del state, step
        return name, losses, (unequal, worst)

    logmel.logmel_launches = 0
    runs = [run("make_train_step", 2, lambda opt, gen: (
        make_train_state(cfg, gen, opt, device=device)[0], make_train_step(cfg, opt, device)[0],
        None))]
    for sp in (False, True):
        runs.append(run(f"make_sharded_train_step(sequence_parallel={sp})", 2,
                        lambda opt, gen, sp=sp: (
                            make_train_state(cfg, gen, opt, mesh=mesh)[0],
                            make_sharded_train_step(cfg, mesh, opt, sequence_parallel=sp)[0],
                            data_sharding(mesh))))
    n_tensors = len(ref)
    ref.clear()  # the pipeline's step is held by its loss alone
    runs.append(run("make_pp_train_step(1 stage, 2 microbatches)", 1, lambda opt, gen: (
        make_pp_train_state(cfg, gen, pp_mesh, opt)[0],
        make_pp_train_step(cfg, pp_mesh, 2, opt)[0], None)))
    ref.clear()
    launches = logmel.logmel_launches
    ref_losses = runs[0][1]
    for name, losses, (unequal, worst) in runs[1:3]:
        if losses != ref_losses or unequal:
            raise AssertionError(f"parallel train: {name} losses {losses} vs {ref_losses}, "
                                 f"{len(unequal)} tensors differ ({unequal[:3]}; largest "
                                 f"|Δ| {worst})")
    pp_loss = runs[3][1][0]
    rel = abs(pp_loss - ref_losses[0]) / abs(ref_losses[0])
    print(f"parallel train: the sharded steps, plain and sequence-parallel, bit-equal to "
          f"make_train_step in both losses and all {n_tensors} tensors; the 1-stage pipeline "
          f"step's loss {pp_loss!r} vs {ref_losses[0]!r} (rel {rel:.3g}, tolerance 1e-5)")
    if rel > 1e-5:
        raise AssertionError(f"parallel train: pipeline loss {pp_loss} vs {ref_losses[0]}")
    return launches


def _train_state_resume(device: str, mesh, d: str) -> int:
    """The sharded train state at test-tiny: 2 steps, saved on the mesh,
    loaded into a fresh template, 1 step == 3 steps bit for bit. Returns
    K1's launches."""
    import torch

    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
        load_train_state,
        save_train_state,
    )
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
    from realtime_whisper_asr_tpu_torch.ops import logmel
    from realtime_whisper_asr_tpu_torch.parallel import data_sharding
    from realtime_whisper_asr_tpu_torch.train.data import DataPipeline, prepare_batch
    from realtime_whisper_asr_tpu_torch.train.train_step import (
        make_sharded_train_step,
        make_train_state,
    )

    cfg = get_config("test-tiny")
    man = write_manifest(d, [(1.0 + 0.25 * i, 3 + i) for i in range(6)])
    batches = list(DataPipeline(man, cfg, MockTokenizer(cfg), batch_size=2, seed=0).epochs(1))
    opt = _recipe(1e-3, 1)
    step, _ = make_sharded_train_step(cfg, mesh, opt)
    logmel.logmel_launches = 0
    prepared = [prepare_batch(x, cfg, device, shard_fn=data_sharding(mesh)) for x in batches]

    def fresh():
        return make_train_state(cfg, torch.Generator(device).manual_seed(0), opt, mesh=mesh)[0]

    straight = fresh()
    for x in prepared[:3]:
        straight, _ = step(straight, x)
    state = fresh()
    for x in prepared[:2]:
        state, _ = step(state, x)
    path = os.path.join(d, "ts")
    save_train_state(path, state, mesh)
    resumed, _ = step(load_train_state(path, fresh(), mesh), prepared[2])
    unequal = [k for k, v in straight.params.items() if not torch.equal(v, resumed.params[k])]
    if unequal or resumed.step != 3:
        raise AssertionError(f"parallel train-state resume: {unequal[:3]}, step {resumed.step}")
    print(f"parallel: sharded train state at test-tiny, mesh {mesh.shape}: 2 steps, saved "
          f"({sorted(os.listdir(path))}), loaded, 1 step == 3 steps, all {len(straight.params)} "
          f"tensors bit-equal")
    return logmel.logmel_launches


def _finetune_torchrun(device: str, d: str) -> None:
    """``tools/finetune.py --mesh 1x1`` at test-tiny under
    ``torch.distributed.run --nproc-per-node 1`` (NCCL on the card): exit 0
    and a checkpoint written."""
    man = write_manifest(d, [(1.0 + 0.25 * i, 3 + i) for i in range(4)])
    out = os.path.join(d, "torchrun")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "realtime_whisper_asr_tpu_torch.tools.finetune", "--manifest", man, "--model",
           "test-tiny", "--out", out, "--batch-size", "2", "--mesh", "1x1", "--save-every", "1",
           "--log-every", "1"] + ([] if torch_device(device).type == "cuda" else ["--cpu"])
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:  # the time limit: torchrun and its worker go
            os.killpg(proc.pid, 9)
            proc.communicate()
    sec = time.perf_counter() - t0
    written = sorted(os.listdir(os.path.join(out, "checkpoint"))) if proc.returncode == 0 else []
    if proc.returncode != 0 or "rtwa_torch.safetensors" not in written:
        raise AssertionError(f"finetune under torchrun: exit {proc.returncode}: {log[-2000:]}")
    line = [ln for ln in log.splitlines() if ln.startswith("{")][-1]
    print(f"parallel: finetune --mesh 1x1 under torch.distributed.run --nproc-per-node 1: exit 0 "
          f"in {sec:.1f} s, {line}, checkpoint {written}, train state "
          f"{sorted(os.listdir(os.path.join(out, 'train_state')))}")


def phase_parallel(smi: str, model_size: str = "large-v3", device: str = "cuda") -> int:
    """The multi-rank path on one card, as a world of one over NCCL at mesh
    1 x 1 and one pipeline stage: the tensor-parallel decode
    (``_parallel_decode``), the dp x tp and pipeline steps of the training
    cell (``_train_runs``), the sharded train state's resume and the
    finetune tool under torchrun. Every collective runs at size 1; the
    checks hold the parallel path bit-equal to the single-card one (the
    pipeline's loss within 1e-5). Returns K1's launches."""
    import tempfile

    import torch.distributed as dist

    from realtime_whisper_asr_tpu_torch.parallel import init_distributed, make_mesh, make_pp_mesh

    t0 = time.perf_counter()
    # this process alone: NCCL on the card (its communicator made at once)
    init_distributed(device, store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_mesh()
    pp_mesh = make_pp_mesh(1)
    print(f"parallel: world of one over {dist.get_backend()} on {mesh.device}, mesh "
          f"{mesh.shape}, pipeline {pp_mesh.shape}")
    with tempfile.TemporaryDirectory() as d:
        launches = _parallel_decode(smi, model_size, device, mesh, d)
        launches += _train_runs(model_size, device, mesh, pp_mesh)
        launches += _train_state_resume(device, mesh, d)
        _finetune_torchrun(device, d)
    dist.destroy_process_group()
    print(f"parallel: {time.perf_counter() - t0:.1f} s; K1 launches {launches}; {smi}")
    return launches


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
    seconds: dict[str, float] = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    kind, smi = run("card", phase_card)
    run("build", phase_build)
    logmel_rows = run("logmel", phase_logmel)
    int4_rows = run("int4", phase_int4)
    linear_rows = run("int4_linear", phase_int4_linear)
    run("int4_linear_kernels", phase_int4_linear_kernels)
    chain_rows = run("chain", phase_chain)
    golden_asr = run("golden", phase_golden, guard)
    run("golden_vac", phase_golden_vac, golden_asr, guard)
    run("ring", phase_ring, golden_asr)
    del golden_asr
    near_ties = run("golden_quant", phase_golden_quant)  # printed again at the end
    run("vad", phase_vad)
    run("separation", phase_separation, smi)
    near_ties += run("app_golden", phase_app_golden, guard, smi)
    launches = {}
    for tier in (None, "int4"):
        launches[tier] = run(f"full_width {tier or 'bf16'}", phase_full_width, guard, tier)
        gc.collect()
        torch.cuda.empty_cache()
    run("checkpoint", phase_checkpoint, guard)
    gc.collect()
    torch.cuda.empty_cache()
    run("headline", phase_headline, guard, smi)
    gc.collect()
    torch.cuda.empty_cache()
    run("serving", phase_serving, guard, smi)
    gc.collect()
    torch.cuda.empty_cache()
    run("beam", phase_beam, guard, smi)
    gc.collect()
    torch.cuda.empty_cache()
    app_launches = run("app", phase_app, guard, smi)
    gc.collect()
    torch.cuda.empty_cache()
    cli_launches = run("cli", phase_cli, smi)
    train_launches = run("train", phase_train, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_launches = run("parallel", phase_parallel, smi)
    run("train_vad", phase_train_vad)
    tools_launches = run("tools", phase_tools, smi)
    gc.collect()
    torch.cuda.empty_cache()
    chain_launches = run("microbench", phase_microbench)
    src = "realtime_whisper_asr_tpu_torch/csrc/"
    entries = []
    for name, source, replaces, count, rows, main_row in (
        # K1: the large-v3 main path's launches, the app path's, the CLI's,
        # the training path's, the parallel path's and the tools'
        ("logmel", src + "logmel.cu", "realtime_whisper_asr_tpu/ops/logmel.py:76",
         launches[None]["logmel"] + app_launches + cli_launches + train_launches
         + parallel_launches + tools_launches, logmel_rows, ("16 s", 128)),
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
    print(f"phase seconds: {seconds}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
