"""Where the time of K1 (the log-mel kernel) goes, on one CUDA card.

    python -m realtime_whisper_asr_tpu_torch.tools.k1_breakdown

Builds variants of ``csrc/logmel.cu`` (one ``nvcc`` each, all at once) and
times them in turns, first to last and back, at the log-mel cases of
``chip_smoke.py`` (8/16/30 s x 80/128 mels, 801 frames, 1 s), each with
a cold and a warm L2 (CUDA events around one launch, median of 30, the card
kept busy while the host enqueues). The variants:

- the kernel, and the first FFT design, which staged each value with a
  load and a store before the next load;
- 2, 4 and 6 frames a block instead of 8;
- the mel loop stepping (frame, mel) without an integer division per
  output, and the real-split loop unrolled;
- the kernel returning at its first line, and right after its staging
  (a wrong result: only their times count), and an empty kernel with no
  shared memory launched on the same grid: the launch, and the launch plus
  one round trip to memory.

The variants that compute the whole function are held against the plain
version (``chip_smoke.py``'s energy-aware tolerances) before they are
timed. One line per variant and case.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.native.build import BUILD_DIR, build_library
from realtime_whisper_asr_tpu_torch.ops import logmel

SR = 16000
#: (label, samples, mels), as chip_smoke.py's LOGMEL_CASES
CASES = tuple((f"{s} s", s * SR, m) for s in (8, 16, 30) for m in (80, 128)) + (
    ("8 s + 160", 8 * SR + 160, 128), ("1 s", SR, 80))

_STAGING = """\
  float v_audio[kAudioPerThread], v_tab[kTabPerThread], v_melw[kMelWPerThread];
  int v_melidx[kMelIdxPerThread];
#pragma unroll
  for (int r = 0; r < kAudioPerThread; ++r) {
    const int j = tid + r * kThreads;
    int64_t i = base + j;
"""
_STAGING_END = """\
    if (tid + r * kThreads < 2 * n_mels + 1) s_melidx[tid + r * kThreads] = v_melidx[r];
  __syncthreads();
"""
_SERIAL_STAGING = """\
  for (int j = tid; j < kSpan; j += kThreads) {
    int64_t i = base + j;
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    s_audio[j] = audio[i];
  }
  for (int j = tid; j < kTabSize; j += kThreads) s_tab[j] = tab[j];
  for (int j = tid; j < nnz; j += kThreads) s_melw[j] = mel_w[j];
  for (int j = tid; j < 2 * n_mels + 1; j += kThreads) s_melidx[j] = mel_idx[j];
  __syncthreads();
"""
_FRAMES = "constexpr int kFrames = 8;"
_MEL = """\
  for (int t = tid; t < valid * n_mels; t += kThreads) {
    const int f = t / n_mels, m = t - f * n_mels;
"""
_MEL_NO_DIVISION = """\
  const int df = kThreads / n_mels, dm = kThreads - df * n_mels;
  for (int f = tid / n_mels, m = tid - (tid / n_mels) * n_mels; f < valid; f += df, m += dm) {
    if (m >= n_mels) {
      m -= n_mels;
      if (++f >= valid) break;
    }
"""
_SPLIT = "  for (int t = tid; t < kFrames * (kN / 2 + 1); t += kThreads) {"
_HEAD = "  const int f0 = blockIdx.x * kFrames;"
_STAGED = "  __syncthreads();\n\n  const float2* win"
_LAUNCH = "  logmel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>("
_NAMESPACE_END = "}  // namespace\n"

#: (variant, [(text of the source, what replaces it), ...], computes the function)
VARIANTS = (
    ("kernel", [], True),
    ("serial staging", [(None, _SERIAL_STAGING)], True),
    ("2 frames a block", [(_FRAMES, "constexpr int kFrames = 2;")], True),
    ("4 frames a block", [(_FRAMES, "constexpr int kFrames = 4;")], True),
    ("6 frames a block", [(_FRAMES, "constexpr int kFrames = 6;")], True),
    ("mel loop, no division", [(_MEL, _MEL_NO_DIVISION)], True),
    ("real split unrolled", [(_SPLIT, "#pragma unroll\n" + _SPLIT)], True),
    ("returns at once", [(_HEAD, "  if (n_frames > 0) return;\n" + _HEAD)], False),
    ("returns after staging",
     [(_STAGED, "  __syncthreads();\n  if (n_frames > 0) {\n"
                "    if (tid == 0 && s_audio[5] == 12345.f) out[0] = s_tab[7] + s_melw[3] + "
                "s_melidx[1];\n    return;\n  }\n\n  const float2* win")], False),
    ("empty, no shared memory",
     [(_NAMESPACE_END, "__global__ void empty_kernel(float* out) {}\n\n" + _NAMESPACE_END),
      (_LAUNCH, "  empty_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(out);\n"
                "  if (0) logmel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(")], False),
)


def _sources() -> dict[str, str]:
    with open(logmel._CU_SRC) as f:
        base = f.read()
    start, end = base.find(_STAGING), base.find(_STAGING_END)
    if base.count(_STAGING) != 1 or base.count(_STAGING_END) != 1 or end < start:
        raise RuntimeError("the kernel's staging block is not in the source once")
    out = {}
    for name, edits, _ in VARIANTS:
        src = base
        for old, new in edits:
            if old is None:  # the staging block
                src = src[:start] + new + src[end + len(_STAGING_END):]
                continue
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its text is not in the source once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build(name: str, source: str) -> ctypes.CDLL:
    tag = name.replace(" ", "_").replace(",", "")
    cu = os.path.join(BUILD_DIR, f"k1_{tag}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(cu) or open(cu).read() != source:
        with open(cu, "w") as f:
            f.write(source)
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return logmel._bind(build_library(
        f"libk1_{tag}.so", [cu],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-shared", "-Xcompiler", "-fPIC", "-o", out, cu]))


def _run(lib: ctypes.CDLL, audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    tab, mel_w, mel_idx = logmel._kernel_tables(audio.device, n_mels)
    out = torch.empty((audio.shape[0] // logmel.HOP_LENGTH, n_mels), device=audio.device)
    index = audio.get_device()
    rc = lib.rtwa_logmel(audio.data_ptr(), audio.shape[0], tab.data_ptr(), mel_w.data_ptr(),
                         mel_idx.data_ptr(), n_mels, mel_w.shape[0], out.data_ptr(), index,
                         torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"rtwa_logmel returned {rc}")
    return out


def _time_us(fn, cold: bool, reps: int = 30) -> float:
    """Median device µs of fn(): CUDA events around one call, the 50 MB L2
    flushed before each when ``cold``, a spin kernel ahead of the start
    event so that the span holds device time only."""
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
        times.append(1e3 * start.elapsed_time(end))
    return float(np.median(times))


def _audio(n: int) -> np.ndarray:
    """A seeded speech-like window of n samples: harmonics, envelope, noise."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    sig = sig * 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t)) + 0.05 * rng.standard_normal(n)
    return (0.5 * sig / np.max(np.abs(sig))).astype(np.float32)


def _check(got: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    diff = (got - ref).abs()
    hot = ref > 0.3
    if not bool(hot.any()) or float(diff[hot].max()) >= 2e-2 or float(diff.mean()) >= 3e-3 \
            or float(diff.max()) >= 0.5:
        raise AssertionError(f"{what}: outside the tolerances of the plain version")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no reading")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip([v[0] for v in VARIANTS],
                        pool.map(lambda kv: _build(*kv), _sources().items())))
    whole = {name for name, _, computes in VARIANTS if computes}
    print("K1 variants: device us per launch, CUDA events, median of 30, cold / warm L2; "
          "each variant timed twice, in turns, first to last and back")
    for label, n, n_mels in CASES:
        a = torch.from_numpy(_audio(n)).cuda()
        plain = logmel.log_mel_spectrogram_plain(a, n_mels)
        times: dict[str, list[float]] = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                def fn(lib=libs[name]):
                    return _run(lib, a, n_mels)

                if name in whole and not times[name]:
                    _check(logmel._normalize(fn()), plain, f"{name} {label}/{n_mels}")
                times[name] += [_time_us(fn, True), _time_us(fn, False)]
        for name, (c1, w1, c2, w2) in times.items():
            print(f"  {label:>9s} / {n_mels:3d} mels  {name:24s} cold {c1:6.2f} {c2:6.2f}  "
                  f"warm {w1:6.2f} {w2:6.2f}")
    print(f"variants {sorted(whole)} within the plain version's tolerances at every case")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
