// Fused chain of bf16 matmuls for Hopper (sm_90a): h <- bf16(h @ W_i) for
// i = 0..k-1 in ONE launch.
//
// Replaces tools/microbench_encoder.py::fused_kernel (the Pallas TPU kernel
// launched by `call`), the encoder microbenchmark's prototype of a layer
// chain that pays one launch instead of k. Each product accumulates in f32
// and rounds its output to bf16 (round to nearest even) before the next, as
// the TPU kernel does.
//
// What bounds it: operations. At T = 800, D = 1280 a product is
// 2*T*D^2 = 2.6 GFLOP, 2.65 us at 989 TFLOP/s bf16, against 3.3 MB of
// weights (0.98 us at 3.35 TB/s); the activation (2 MB) never needs to
// leave the 50 MB L2.
//
// What this first design does about it: the TPU kernel kept the activation
// in VMEM scratch across grid steps; on Hopper no SM's shared memory holds
// 2 MB, so
//   * a persistent cooperative kernel (cudaLaunchCooperativeKernel) tiles
//     the (T, D) output into 64 x 128 tiles (130 tiles at 800 x 1280 on 132
//     SMs) and separates the products with a grid-wide barrier;
//   * two activation buffers in device memory are used in turn (read one,
//     write the other); at 2 x 2 MB they stay in L2, and each weight matrix
//     is streamed once per product per tile column;
//   * the inner product is WMMA bf16 16x16x16 with f32 accumulators, from
//     64 x 32 and 32 x 128 tiles staged in shared memory, 8 warps each
//     owning a 32 x 32 piece of the tile; the f32 tile is rounded to bf16 on
//     its way out. wgmma, TMA and a multi-stage pipeline are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int LDA = BK + 8;    // bf16 elements; 80-byte rows
constexpr int LDB = BN + 8;    // 272-byte rows
constexpr int LDC = BN + 4;    // f32 elements

__global__ void __launch_bounds__(kThreads)
matmul_chain_kernel(const __nv_bfloat16* x, const __nv_bfloat16* __restrict__ ws,
                    __nv_bfloat16* buf0, __nv_bfloat16* buf1, __nv_bfloat16* out,
                    int T, int D, int k) {
  __shared__ __align__(32) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 sB[BK * LDB];
  __shared__ __align__(32) float sC[BM * LDC];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 4;  // warp row: 0..1, 32 rows each
  const int wc = warp % 4;  // warp column: 0..3, 32 columns each
  const int tiles_m = (T + BM - 1) / BM;
  const int tiles_n = D / BN;
  const int n_tiles = tiles_m * tiles_n;

  for (int step = 0; step < k; ++step) {
    // activations are written by other blocks in the previous step: they
    // are read at L2 (__ldcg), never through an SM's L1 or read-only cache
    const __nv_bfloat16* src = step == 0 ? x : (step % 2 ? buf0 : buf1);
    __nv_bfloat16* dst = step == k - 1 ? out : (step % 2 ? buf1 : buf0);
    const __nv_bfloat16* w = ws + (int64_t)step * D * D;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM;
      const int n0 = (tile % tiles_n) * BN;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

      for (int k0 = 0; k0 < D; k0 += BK) {
        __syncthreads();  // the previous k-step's fragments are loaded
        {  // A: 64 rows x 32 bf16 = one 16-byte vector per thread
          const int r = tid / 4, c = (tid % 4) * 8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (m0 + r < T) v = __ldcg(reinterpret_cast<const uint4*>(src + (int64_t)(m0 + r) * D + k0 + c));
          *reinterpret_cast<uint4*>(&sA[r * LDA + c]) = v;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // B: 32 rows x 128 bf16, two vectors per thread
          const int idx = tid + i * kThreads;
          const int r = idx / 16, c = (idx % 16) * 8;
          *reinterpret_cast<uint4*>(&sB[r * LDB + c]) =
              *reinterpret_cast<const uint4*>(w + (int64_t)(k0 + r) * D + n0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], &sA[(wr * 32 + i * 16) * LDA + kk], LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], &sB[kk * LDB + wc * 32 + j * 16], LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(&sC[(wr * 32 + i * 16) * LDC + wc * 32 + j * 16], acc[i][j],
                                  LDC, wmma::mem_row_major);
      __syncthreads();
      // round to bf16 (nearest even) and write the tile, 8 values a thread-step
      for (int idx = tid; idx < BM * BN / 8; idx += kThreads) {
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        if (m0 + r >= T) continue;
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(sC[r * LDC + c + e]);
        *reinterpret_cast<uint4*>(dst + (int64_t)(m0 + r) * D + n0 + c) =
            *reinterpret_cast<const uint4*>(v);
      }
      // sC is rewritten only after the next tile's k-loop, past its syncs
    }
    if (step + 1 < k) grid.sync();  // every tile of this product is written
  }
}

}  // namespace

// Launches the cooperative kernel on `stream` without synchronising and
// returns the launch's error (or cudaGetLastError()). The grid is as many
// blocks as tiles, capped at what the card holds at once, which a grid-wide
// barrier requires. The caller checks D % 128 == 0, T >= 1, k >= 1,
// contiguous bf16 tensors with 16-byte aligned rows.
extern "C" int rtwa_matmul_chain(const void* x, const void* ws, void* buf0, void* buf1,
                                 void* out, int T, int D, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matmul_chain_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((T + BM - 1) / BM) * (D / BN);
  int grid = per_sm * sms;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(ws);
  __nv_bfloat16* b0 = static_cast<__nv_bfloat16*>(buf0);
  __nv_bfloat16* b1 = static_cast<__nv_bfloat16*>(buf1);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  void* args[] = {&xb, &wb, &b0, &b1, &ob, &T, &D, &k};
  err = cudaLaunchCooperativeKernel((void*)matmul_chain_kernel, dim3(grid), dim3(kThreads), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* rtwa_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
