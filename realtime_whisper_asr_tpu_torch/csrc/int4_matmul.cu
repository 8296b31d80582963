// Packed-int4 weight matmul for Hopper (sm_90a): y = sum_g s[g,n] * (xq_g . w4_g).
//
// Replaces realtime_whisper_asr_tpu/ops/int4_matmul.py::_kernel (the Pallas
// TPU kernel launched by int4_matmul) and, on the card, the XLA grouped-int32
// formulation of model._linear's int4 branch: every int4 product of the
// "int4" / "int4-all" tiers (decode steps at M = 1, prefill spans, the
// cross-K/V projection at M = 400 / 800 / 1500) comes here.
//
//   xq (M, K) int8 activations, row-major
//   wp (K/2, N) int8: two int4 weights per byte, input row 2i in the low
//      nibble and 2i+1 in the high nibble (quant.pack_int4's layout)
//   s  (G, N) f32 scales, one per column per group of K/G input rows
//   y  (M, N) f32 = sum over g, in order, of fl(float(P_g[m,n]) * s[g,n]),
//      P_g the exact int32 product of group g
//
// Numerics: each group's partial sum is exact int32 (__dp4a); the scale is
// applied with a rounded multiply and the groups are summed in order with
// rounded adds (no FMA contraction), which is also what the plain version
// (ops/int4_matmul.py) computes, so the two agree bit for bit. The TPU
// kernel instead folded each group's scale into bf16 weight planes (<= 0.4 %
// error) because Mosaic could not legalise int8 shifts there; Hopper has
// native int8 dot products, so no fold is carried over.
//
// What bounds it: at decode (M = 1) bytes: the packed weights (K/2 * N),
// scales (4 * G * N), activations and output, over 3.35 TB/s (~1.0 us for
// large-v3's fc1, 1280 -> 5120). At the cross-K/V shape (M = 800) the int8
// operations 2*M*K*N over 1,979 TOPS come close to that.
//
// What this first design does about it (simple and right; wgmma, TMA and
// split-K across blocks are later work):
//   * the packed bytes are read once per block with 32-bit loads (four
//     columns of one packed row per thread, neighbouring threads on
//     neighbouring words), so the 4-bit weights are what crosses HBM;
//   * each chunk of up to 128 input rows is unpacked in shared memory into
//     per-column runs of int8 values (low nibble sign-extended by shifts,
//     high nibble by an arithmetic shift), so a 32-bit shared load yields
//     four consecutive k of one column for __dp4a;
//   * the activation chunk is staged beside it as 32-bit words, a broadcast
//     to the threads that share a row;
//   * two tile shapes: for M <= 4 a block takes 32 columns x 4 rows and
//     splits each chunk's k across 8 thread slices (reduced in shared memory
//     at the group's end), which keeps 256 threads busy at M = 1; for larger
//     M a block takes 64 columns x 32 rows, each thread 8 rows of one column,
//     so each weight byte staged feeds 32 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;  // input rows staged per step (at most one group)

template <int BN, int BM, int TM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wp,
                   const float* __restrict__ s, float* __restrict__ y,
                   int M, int K, int N, int G) {
  constexpr int RG = BM / TM;              // row groups
  constexpr int KS = kThreads / (BN * RG);  // k slices
  static_assert(BN * RG * KS == kThreads, "thread tiling");
  constexpr int CW = kChunk / 4;           // 32-bit words per column per chunk
  constexpr int WS = CW + 1;               // padded stride (bank spread)

  __shared__ int32_t s_w[BN * WS];         // unpacked weights, per column
  __shared__ int32_t s_x[BM * CW];         // activation words, per row
  __shared__ int32_t s_red[KS > 1 ? KS * BM * BN : 1];

  const int tid = threadIdx.x;
  const int tn = tid % BN;
  const int rg = (tid / BN) % RG;
  const int ks = tid / (BN * RG);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int gs = K / G;                    // input rows per group
  const int chunk = gs < kChunk ? gs : kChunk;
  const int cw = chunk / 4;                // words per column in this chunk
  const int wpk = cw / KS;                 // words per k slice

  float out[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) out[t] = 0.f;

  for (int g = 0; g < G; ++g) {
    int32_t acc[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) acc[t] = 0;
    for (int k0 = g * gs; k0 < (g + 1) * gs; k0 += chunk) {
      __syncthreads();  // the previous chunk's readers are done
      // stage the packed weights: chunk/2 rows x BN columns, 4 columns a word
      const int wrow = BN / 4;
      for (int i = tid; i < (chunk / 2) * wrow; i += kThreads) {
        const int pr = i / wrow, c4 = (i % wrow) * 4;
        uint32_t word = 0;
        if (n0 + c4 < N)
          word = *reinterpret_cast<const uint32_t*>(wp + (int64_t)(k0 / 2 + pr) * N + n0 + c4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = (int)(int8_t)(word >> (8 * j));
          const int lo = (int)((unsigned)v << 28) >> 28;  // sign-extended low nibble: row 2pr
          const int hi = v >> 4;           // arithmetic shift: row 2pr + 1
          reinterpret_cast<uint16_t*>(s_w)[((c4 + j) * WS * 4 + 2 * pr) / 2] =
              (uint16_t)((lo & 0xFF) | ((hi & 0xFF) << 8));
        }
      }
      // stage the activations: BM rows x chunk k, 4 k a word
      for (int i = tid; i < BM * cw; i += kThreads) {
        const int r = i / cw, w = i % cw;
        s_x[r * CW + w] = (m0 + r < M)
            ? *reinterpret_cast<const int32_t*>(xq + (int64_t)(m0 + r) * K + k0 + 4 * w) : 0;
      }
      __syncthreads();
      const int32_t* wcol = s_w + tn * WS;
      for (int w = ks * wpk; w < (ks + 1) * wpk; ++w) {
        const int32_t wv = wcol[w];
#pragma unroll
        for (int t = 0; t < TM; ++t) acc[t] = __dp4a(s_x[(rg * TM + t) * CW + w], wv, acc[t]);
      }
    }
    // group end: exact int32 reduction over k slices, then the scale fold
    if (KS > 1) {
#pragma unroll
      for (int t = 0; t < TM; ++t) s_red[(ks * BM + rg * TM + t) * BN + tn] = acc[t];
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          int32_t sum = 0;
          for (int j = 0; j < KS; ++j) sum += s_red[(j * BM + rg * TM + t) * BN + tn];
          acc[t] = sum;
        }
      }
      // s_red is next written after the next group's chunks, past two syncs
    }
    if (ks == 0 && n0 + tn < N) {
      const float sc = s[(int64_t)g * N + n0 + tn];
#pragma unroll
      for (int t = 0; t < TM; ++t) out[t] = __fadd_rn(out[t], __fmul_rn((float)acc[t], sc));
    }
  }
  if (ks == 0 && n0 + tn < N) {
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int m = m0 + rg * TM + t;
      if (m < M) y[(int64_t)m * N + n0 + tn] = out[t];
    }
  }
}

template <int BN, int BM, int TM>
int launch(const int8_t* xq, const int8_t* wp, const float* s, float* y, int M, int K, int N,
           int G, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int4_matmul_kernel<BN, BM, TM><<<grid, kThreads, 0, stream>>>(xq, wp, s, y, M, K, N, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising and
// returns cudaGetLastError(). The caller checks the types and shapes:
// K even, N % 4 == 0, K % 4 == 0, K/G a multiple of 32 that is at most 128
// or a multiple of 128, and 4-byte aligned pointers.
extern "C" int rtwa_int4_matmul(const int8_t* xq, const int8_t* wp, const float* s, float* y,
                                int M, int K, int N, int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 4) return launch<32, 4, 4>(xq, wp, s, y, M, K, N, G, (cudaStream_t)stream);
  return launch<64, 32, 8>(xq, wp, s, y, M, K, N, G, (cudaStream_t)stream);
}

extern "C" const char* rtwa_int4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
