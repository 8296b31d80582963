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
// The TPU kernel takes the STFT as two MXU matmuls against dense (400 x 201)
// window-folded DFT bases, which is cheap on a TPU. On Hopper in IEEE f32 the
// dense DFT costs 321,600 FLOP a frame on the CUDA cores, and a block has to
// read the 643 KB of bases through L2 whatever its share of the frames.
//
// This design takes a real FFT in shared memory instead. Per frame:
//   * pack: the 400 windowed samples as 200 complex values
//     z[n] = w[2n]·x[2n] + i·w[2n+1]·x[2n+1];
//   * a 200-point complex FFT as 8 x 25 (n = 25·n1 + n2, k = k1 + 8·k2):
//     25 radix-8 butterflies over n1, a twiddle by W_200^(n2·k1), then each
//     of the 8 length-25 DFTs over n2 as 5 x 5 (n2 = 5·a + b,
//     k2 = c + 5·d): 5 radix-5 butterflies over a, a twiddle by W_25^(b·c),
//     5 radix-5 butterflies over b. Bin k1 + 8·c + 40·d lands in natural
//     order when the last pass stores it;
//   * real split: X[k] = ½(Z[k] + Z*[200−k]) − ½·i·W_400^k·(Z[k] − Z*[200−k])
//     for k = 0..200 (Z[200] ≡ Z[0]), one thread per pair (k, 200 − k);
//   * power, then each mel filter summed over its nonzero bins only (the
//     skipped terms are exact zeros), then log10f.
// W_N^j = exp(−2πi·j/N). Every twiddle and the window come from one table
// built on the host in float64 and rounded once to f32
// (ops/logmel.py::fft_tables; its layout is kTab* below), so no sine or
// cosine is evaluated here and no fast-math intrinsic is used.
//
// What bounds it: ~12 kFLOP a frame (26x fewer than the dense DFT), so at
// 16 s / 128 mels the f32 operations take ~0.3 µs at 67 TFLOP/s against
// ~0.55 µs for the bytes that must move (audio in, log-mel out, at
// 3.35 TB/s): bytes bound the work, and what the card shows above that is
// latency: the launch, one round trip to memory, and the chain of
// dependent shared-memory passes of a block (PERF.md has the split).
//
// What the design does about it:
//   * one phase of global loads per block, every load of a thread issued
//     into registers before the first store to shared memory: its frames'
//     contiguous audio span ((kFrames-1)·hop + N_FFT samples, reflect
//     indices computed here, so the overlapping frames matrix never touches
//     device memory), the 5 KB twiddle table and the compact mel weights;
//   * then five passes over shared memory only (radix 8, radix 5, radix 5,
//     real split, mel + log), one __syncthreads apart, each butterfly kept in
//     registers; a block has one thread per radix-5 butterfly of its frames
//     (kFrames x 40);
//   * kFrames = 8 puts 100 blocks in flight for the 8 s streaming window and
//     375 at 30 s, all resident at once; 2, 4 and 6 frames a block timed
//     slower on the H100 at every window;
//   * only the (n_frames, n_mels) log spectrum is written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kNFreq = kNFFT / 2 + 1;   // 201 real-DFT bins
constexpr int kN = kNFFT / 2;           // 200-point complex FFT
constexpr int kFrames = 8;              // frames per block
constexpr int kThreads = kFrames * 40;  // one thread per radix-5 butterfly
constexpr int kSpan = (kFrames - 1) * kHop + kNFFT;
constexpr int kMaxMels = 128;
constexpr int kMaxMelWeights = 1024;

// The table of ops/logmel.py::fft_tables, in floats; complex entries are
// (re, im) pairs.
constexpr int kTabWindow = 0;  // periodic Hann window, 400
constexpr int kTabW8 = 400;    // W_8^j, j < 8
constexpr int kTabW200 = 416;  // W_200^(k1·n2), [k1 < 8][n2 < 25]
constexpr int kTabW5 = 816;    // W_5^j, j < 5
constexpr int kTabW25 = 826;   // W_25^(c·b), [c < 5][b < 5]
constexpr int kTabW400 = 876;  // W_400^k, k <= 200
constexpr int kTabSize = 1278;

// staged values per thread
constexpr int kAudioPerThread = (kSpan + kThreads - 1) / kThreads;
constexpr int kTabPerThread = (kTabSize + kThreads - 1) / kThreads;
constexpr int kMelWPerThread = (kMaxMelWeights + kThreads - 1) / kThreads;
constexpr int kMelIdxPerThread = (2 * kMaxMels + 1 + kThreads - 1) / kThreads;

static_assert(kN == 8 * 25, "200 = 8 x 25");
static_assert(kHop % 2 == 0, "float2 reads of a frame's staged samples");
static_assert(kFrames * kNFreq <= 2 * kFrames * kN, "power rows fit the second buffer");

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// 3-bit reversal: where the radix-2 stages of dft8 leave bin k
__host__ __device__ constexpr int rev3(int k) { return ((k & 1) << 2) | (k & 2) | (k >> 2); }

// a[j] <- sum_n a[n]·W_8^(n·j), left in bit-reversed order (bin k at
// a[rev3(k)]): three radix-2 decimation-in-frequency stages.
__device__ __forceinline__ void dft8(float2 a[8], const float2* w8) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float2 s = cadd(a[n], a[n + 4]), d = csub(a[n], a[n + 4]);
    a[n] = s;
    a[n + 4] = cmul(d, w8[n]);
  }
#pragma unroll
  for (int h = 0; h < 8; h += 4) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 s = cadd(a[h + n], a[h + n + 2]), d = csub(a[h + n], a[h + n + 2]);
      a[h + n] = s;
      a[h + n + 2] = cmul(d, w8[2 * n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    const float2 s = cadd(a[n], a[n + 1]), d = csub(a[n], a[n + 1]);
    a[n] = s;
    a[n + 1] = d;
  }
}

// u[j] <- sum_a u[a]·W_5^(a·j), in natural order, with W_5^1 = (c1, −s1)
// and W_5^2 = (c2, −s2): the pairs (1, 4) and (2, 3) share their cosines.
__device__ __forceinline__ void dft5(float2 u[5], float c1, float s1, float c2, float s2) {
  const float2 a1 = cadd(u[1], u[4]), b1 = csub(u[1], u[4]);
  const float2 a2 = cadd(u[2], u[3]), b2 = csub(u[2], u[3]);
  const float2 t1 = make_float2(u[0].x + c1 * a1.x + c2 * a2.x, u[0].y + c1 * a1.y + c2 * a2.y);
  const float2 t2 = make_float2(u[0].x + c2 * a1.x + c1 * a2.x, u[0].y + c2 * a1.y + c1 * a2.y);
  const float2 q1 = make_float2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y);
  const float2 q2 = make_float2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y);
  u[0] = make_float2(u[0].x + a1.x + a2.x, u[0].y + a1.y + a2.y);
  // X1 = t1 − i·q1, X4 = t1 + i·q1, X2 = t2 − i·q2, X3 = t2 + i·q2
  u[1] = make_float2(t1.x + q1.y, t1.y - q1.x);
  u[4] = make_float2(t1.x - q1.y, t1.y + q1.x);
  u[2] = make_float2(t2.x + q2.y, t2.y - q2.x);
  u[3] = make_float2(t2.x - q2.y, t2.y + q2.x);
}

__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ audio, int64_t n, int n_frames,
              const float* __restrict__ tab,      // (kTabSize,) window and twiddles
              const float* __restrict__ mel_w,    // (nnz,) nonzero weights, filter by filter
              const int* __restrict__ mel_idx,    // (2·n_mels + 1,) first bins, then offsets
              int n_mels, int nnz,
              float* __restrict__ out) {          // (n_frames, n_mels)
  __shared__ __align__(16) float s_audio[kSpan];
  __shared__ __align__(16) float s_tab[kTabSize];
  __shared__ float s_melw[kMaxMelWeights];
  __shared__ int s_melidx[2 * kMaxMels + 1];
  __shared__ float2 s_a[kFrames * kN];
  __shared__ float2 s_b[kFrames * kN];  // after the last radix-5 pass: the power rows

  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;

  // 1. Stage the tile's audio span, the table and the mel weights: every
  //    load of a thread is issued into registers before the first store, so
  //    the block waits for one round trip to memory, not one per element.
  //    Padded position j of frame f0 is sample f0*hop + j - N_FFT/2; reflect
  //    at both ends as numpy's mode="reflect".
  const int64_t base = (int64_t)f0 * kHop - kNFFT / 2;
  float v_audio[kAudioPerThread], v_tab[kTabPerThread], v_melw[kMelWPerThread];
  int v_melidx[kMelIdxPerThread];
#pragma unroll
  for (int r = 0; r < kAudioPerThread; ++r) {
    const int j = tid + r * kThreads;
    int64_t i = base + j;
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    // only frames past n_frames in the last tile reach beyond the reflected
    // range; clamp their reads (their outputs are never stored)
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    if (j < kSpan) v_audio[r] = audio[i];
  }
#pragma unroll
  for (int r = 0; r < kTabPerThread; ++r) {
    const int j = tid + r * kThreads;
    if (j < kTabSize) v_tab[r] = tab[j];
  }
#pragma unroll
  for (int r = 0; r < kMelWPerThread; ++r) {
    const int j = tid + r * kThreads;
    if (j < nnz) v_melw[r] = mel_w[j];
  }
#pragma unroll
  for (int r = 0; r < kMelIdxPerThread; ++r) {
    const int j = tid + r * kThreads;
    if (j < 2 * n_mels + 1) v_melidx[r] = mel_idx[j];
  }
#pragma unroll
  for (int r = 0; r < kAudioPerThread; ++r)
    if (tid + r * kThreads < kSpan) s_audio[tid + r * kThreads] = v_audio[r];
#pragma unroll
  for (int r = 0; r < kTabPerThread; ++r)
    if (tid + r * kThreads < kTabSize) s_tab[tid + r * kThreads] = v_tab[r];
#pragma unroll
  for (int r = 0; r < kMelWPerThread; ++r)
    if (tid + r * kThreads < nnz) s_melw[tid + r * kThreads] = v_melw[r];
#pragma unroll
  for (int r = 0; r < kMelIdxPerThread; ++r)
    if (tid + r * kThreads < 2 * n_mels + 1) s_melidx[tid + r * kThreads] = v_melidx[r];
  __syncthreads();

  const float2* win = reinterpret_cast<const float2*>(s_tab + kTabWindow);
  const float2* w8 = reinterpret_cast<const float2*>(s_tab + kTabW8);
  const float2* w200 = reinterpret_cast<const float2*>(s_tab + kTabW200);
  const float2* w5 = reinterpret_cast<const float2*>(s_tab + kTabW5);
  const float2* w25 = reinterpret_cast<const float2*>(s_tab + kTabW25);
  const float2* w400 = reinterpret_cast<const float2*>(s_tab + kTabW400);
  const float c1 = w5[1].x, s1 = -w5[1].y, c2 = w5[2].x, s2 = -w5[2].y;

  // 2. Radix 8 over n1, thread (f, n2): the packed, windowed z[25·n1 + n2],
  //    then bin k1 times W_200^(k1·n2) to s_a[f][k1·25 + n2].
  if (tid < kFrames * 25) {
    const int f = tid / 25, n2 = tid - f * 25;
    const float2* x = reinterpret_cast<const float2*>(s_audio + f * kHop);
    float2 a[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const float2 v = x[25 * n1 + n2], w = win[25 * n1 + n2];
      a[n1] = make_float2(w.x * v.x, w.y * v.y);
    }
    dft8(a, w8);
    float2* o = s_a + f * kN + n2;
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) o[25 * k1] = cmul(a[rev3(k1)], w200[25 * k1 + n2]);
  }
  __syncthreads();

  // 3. Radix 5 over a (n2 = 5·a + b), thread (f, k1, b): bin c times
  //    W_25^(c·b) to s_b[f][k1·25 + 5·c + b].
  {
    const int f = tid / 40, r = tid - f * 40, k1 = r / 5, b = r - k1 * 5;
    const float2* in = s_a + f * kN + 25 * k1 + b;
    float2 u[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) u[a] = in[5 * a];
    dft5(u, c1, s1, c2, s2);
    float2* o = s_b + f * kN + 25 * k1 + b;
#pragma unroll
    for (int c = 0; c < 5; ++c) o[5 * c] = cmul(u[c], w25[5 * c + b]);
  }
  __syncthreads();

  // 4. Radix 5 over b, thread (f, k1, c): bin d is Z[k1 + 8·c + 40·d], stored
  //    in natural order to s_a[f].
  {
    const int f = tid / 40, r = tid - f * 40, k1 = r / 5, c = r - k1 * 5;
    const float2* in = s_b + f * kN + 25 * k1 + 5 * c;
    float2 u[5];
#pragma unroll
    for (int b = 0; b < 5; ++b) u[b] = in[b];
    dft5(u, c1, s1, c2, s2);
    float2* o = s_a + f * kN + k1 + 8 * c;
#pragma unroll
    for (int d = 0; d < 5; ++d) o[40 * d] = u[d];
  }
  __syncthreads();

  // 5. Real split and power, thread (f, k) for k <= 100: with
  //    e = ½(Z[k] + Z*[200−k]), d = ½(Z[k] − Z*[200−k]) and p = W_400^k·d,
  //    X[k] = e − i·p and X[200−k] = conj(e + i·p).
  float* s_power = reinterpret_cast<float*>(s_b);  // (kFrames, kNFreq)
  for (int t = tid; t < kFrames * (kN / 2 + 1); t += kThreads) {
    const int f = t / (kN / 2 + 1), k = t - f * (kN / 2 + 1);
    const float2* z = s_a + f * kN;
    const float2 zk = z[k], zm = z[k == 0 ? 0 : kN - k];
    const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 d = make_float2(0.5f * (zk.x - zm.x), 0.5f * (zk.y + zm.y));
    const float2 p = cmul(w400[k], d);
    const float xr = e.x + p.y, xi = e.y - p.x;
    const float yr = e.x - p.y, yi = e.y + p.x;
    s_power[f * kNFreq + k] = xr * xr + xi * xi;
    if (k < kN / 2) s_power[f * kNFreq + kN - k] = yr * yr + yi * yi;
  }
  __syncthreads();

  // 6. Mel projection and log10 floor: one (frame, mel) output per step;
  //    neighbouring threads take neighbouring mels, so the stores coalesce.
  const int valid = min(kFrames, n_frames - f0);
  for (int t = tid; t < valid * n_mels; t += kThreads) {
    const int f = t / n_mels, m = t - f * n_mels;
    const float* p = s_power + f * kNFreq + s_melidx[m];  // from the filter's first bin
    const int w0 = s_melidx[n_mels + m], w1 = s_melidx[n_mels + m + 1];
    float acc = 0.f;
    for (int j = w0; j < w1; ++j) acc = fmaf(p[j - w0], s_melw[j], acc);
    out[(int64_t)(f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising and
// returns cudaGetLastError(): a refused launch never runs and would otherwise
// go unreported. Refuses (cudaErrorInvalidValue) more mels or mel weights than
// the shared arrays hold. The caller checks n % 160 == 0 and n > 200.
extern "C" int rtwa_logmel(const float* audio, int64_t n, const float* tab, const float* mel_w,
                           const int* mel_idx, int n_mels, int nnz, float* out, int device,
                           void* stream) {
  if (n_mels < 1 || n_mels > kMaxMels || nnz < 0 || nnz > kMaxMelWeights)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_frames = (int)(n / kHop);
  const int grid = (n_frames + kFrames - 1) / kFrames;
  logmel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(audio, n, n_frames, tab, mel_w,
                                                             mel_idx, n_mels, nnz, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtwa_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
