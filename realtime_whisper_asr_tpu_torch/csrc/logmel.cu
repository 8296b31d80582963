// Whisper log-mel frontend for Hopper (sm_90a), one launch per audio window.
//
// Replaces realtime_whisper_asr_tpu/ops/logmel.py::_logmel_kernel (the fused
// Pallas TPU kernel) and the XLA framing gather in front of it. It computes,
// for every 10 ms frame of the window,
//     log10(max(melT^T · |rfft(hann · frame)|^2, 1e-10))
// with reflect padding of N_FFT/2 at both ends (Whisper's centred STFT; the
// last centred frame is dropped). The global clamp to max - 8 and the
// (x + 4) / 4 normalisation stay outside, as two torch ops in ops/logmel.py.
//
// What bounds it: by its work, arithmetic on the f32 CUDA cores. At 30 s
// (3000 frames) the DFT is ~0.97 GFLOP and the mel projection, over the
// filterbank's ~390 nonzero entries, ~2.4 MFLOP, while the bytes that must
// move are ~4 MB (audio, bases, output). ~240 FLOP per byte is far above the
// H100's f32 ridge point (67 TFLOP/s / 3.35 TB/s = 20), so the FP32 pipes,
// not HBM, set the floor of this design (a dense DFT; an FFT would need ~20x
// fewer operations).
// The DFT stays in IEEE f32 FMA (no TF32 tensor cores): the hot-bin tolerance
// of the parity tests is tighter than TF32's 10-bit mantissa allows. As
// written, the kernel runs well above that floor (PERF.md): a block's time is
// set by its serial walk over the 400 basis rows, whose loads come from L2 or
// a cold HBM, not by its FMAs.
//
// What the design does about it:
//   * framing is fused into the loads: a block owns kFrames consecutive frames
//     and stages their contiguous audio span ((kFrames-1)*hop + N_FFT samples)
//     in shared memory once, computing reflect indices itself, so the
//     overlapping (n_frames, 400) frames matrix never touches device memory;
//   * thread k owns DFT bin k for all kFrames frames, accumulating in
//     registers; each window-folded basis value (w*cos, w*sin; 400 x 201 f32,
//     read through L2) feeds 2*kFrames FMAs, and each float4 of staged audio
//     is a shared-memory broadcast feeding 8 FMAs;
//   * few frames per block (kFrames = 8) put 100 blocks in flight for the 8 s
//     streaming window instead of 25, and the basis loop is unrolled so more
//     loads are in flight per thread: both shorten the serial walk that
//     bounds a block (the tile sizes were chosen by timing variants on the
//     H100);
//   * the power spectrum stays in shared memory (kFrames x 201 floats) for the
//     mel projection, which sums each filter only over its nonzero triangular
//     support (mel_lo..mel_hi, ~3-5 bins instead of 201; the skipped terms are
//     exact zeros, so the sums equal the dense ones); only the
//     (n_frames, n_mels) log spectrum is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kNFreq = kNFFT / 2 + 1;  // 201 real-DFT bins
constexpr int kFrames = 8;             // frames per block
constexpr int kThreads = 256;          // >= kNFreq: one DFT bin per thread
constexpr int kSpan = (kFrames - 1) * kHop + kNFFT;

static_assert(kThreads >= kNFreq, "one thread per DFT bin");
static_assert(kHop % 4 == 0 && kNFFT % 4 == 0, "float4 reads of the staged audio");

__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ audio, int64_t n, int n_frames,
              const float* __restrict__ cosw,  // (kNFFT, kNFreq) hann * cos
              const float* __restrict__ sinw,  // (kNFFT, kNFreq) hann * -sin
              const float* __restrict__ melT,  // (kNFreq, n_mels)
              const int* __restrict__ mel_lo,  // (n_mels,) first nonzero bin
              const int* __restrict__ mel_hi,  // (n_mels,) last nonzero bin + 1
              int n_mels,
              float* __restrict__ out) {       // (n_frames, n_mels)
  __shared__ __align__(16) float s_audio[kSpan];
  __shared__ float s_power[kFrames * kNFreq];

  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;

  // 1. Stage the tile's audio span. Padded position j of frame f0 is sample
  //    f0*hop + j - N_FFT/2; reflect at both ends as numpy's mode="reflect".
  const int64_t base = (int64_t)f0 * kHop - kNFFT / 2;
  for (int j = tid; j < kSpan; j += kThreads) {
    int64_t i = base + j;
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    // only frames past n_frames in the last tile reach beyond the reflected
    // range; clamp their reads (their outputs are never stored)
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    s_audio[j] = audio[i];
  }
  __syncthreads();

  // 2. Real DFT: thread k accumulates bin k of every frame in registers.
  const int k = tid;
  if (k < kNFreq) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
#pragma unroll 8
    for (int t = 0; t < kNFFT; t += 4) {
      const float c0 = cosw[(t + 0) * kNFreq + k], s0 = sinw[(t + 0) * kNFreq + k];
      const float c1 = cosw[(t + 1) * kNFreq + k], s1 = sinw[(t + 1) * kNFreq + k];
      const float c2 = cosw[(t + 2) * kNFreq + k], s2 = sinw[(t + 2) * kNFreq + k];
      const float c3 = cosw[(t + 3) * kNFreq + k], s3 = sinw[(t + 3) * kNFreq + k];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(&s_audio[f * kHop + t]);
        re[f] = fmaf(x.x, c0, re[f]);
        im[f] = fmaf(x.x, s0, im[f]);
        re[f] = fmaf(x.y, c1, re[f]);
        im[f] = fmaf(x.y, s1, im[f]);
        re[f] = fmaf(x.z, c2, re[f]);
        im[f] = fmaf(x.z, s2, im[f]);
        re[f] = fmaf(x.w, c3, re[f]);
        im[f] = fmaf(x.w, s3, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) s_power[f * kNFreq + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // 3. Mel projection and log10 floor: one (frame, mel) output per step;
  //    neighbouring threads take neighbouring mels, so melT reads coalesce and
  //    the power row is a shared-memory broadcast.
  const int valid = min(kFrames, n_frames - f0);
  for (int idx = tid; idx < valid * n_mels; idx += kThreads) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    const float* p = &s_power[f * kNFreq];
    float acc = 0.f;
    for (int b = mel_lo[m]; b < mel_hi[m]; ++b) acc = fmaf(p[b], melT[b * n_mels + m], acc);
    out[(int64_t)(f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising and
// returns cudaGetLastError(): a refused launch never runs and would otherwise
// go unreported. The caller checks n % 160 == 0 and n > 200.
extern "C" int rtwa_logmel(const float* audio, int64_t n, const float* cosw,
                           const float* sinw, const float* melT, const int* mel_lo,
                           const int* mel_hi, int n_mels, float* out, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_frames = (int)(n / kHop);
  const int grid = (n_frames + kFrames - 1) / kFrames;
  logmel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      audio, n, n_frames, cosw, sinw, melT, mel_lo, mel_hi, n_mels, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtwa_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
