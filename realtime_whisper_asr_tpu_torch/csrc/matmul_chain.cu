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
// What the design does about it: the full bf16 rate is reached only through
// wgmma fed from shared memory by TMA, so
//   * a persistent cooperative kernel tiles the (T, D) output into 64 x 128
//     tiles (130 tiles at 800 x 1280 on 132 SMs, one per SM) and separates
//     the products with a grid-wide barrier; two activation buffers in device
//     memory (L2-resident) are read and written in turn;
//   * one producer warp keeps TMA loads in flight through a 4-stage ring in
//     dynamic shared memory, 128-byte swizzled: per stage a 64 x 64 slice of
//     the activation (K-major) and a 64 x 128 slice of W (N-major, two
//     64-column boxes), with full/empty mbarriers between it and the
//     consumers; the ring runs on across tiles, so a tile's epilogue overlaps
//     the next tile's loads;
//   * one consumer warpgroup issues wgmma.mma_async m64n128k16 (bf16 in, f32
//     accumulators in registers) with B read transposed from shared memory,
//     then rounds the tile to bf16 and stores it;
//   * between products the epilogue's generic stores are made visible to the
//     next product's TMA reads (the async proxy) of other SMs with
//     fence.proxy.async.global before the grid barrier, and again after it
//     on the loading side.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = 128, BK = 64, kStages = 4;
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kABytes = BM * BK * 2;          // 8 KB
constexpr int kBHalfBytes = BK * 64 * 2;      // 8 KB: 64 k rows x 64 columns
constexpr int kStageBytes = kABytes + 2 * kBHalfBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of parity `parity` has completed. A transfer that
// never lands traps after ~2 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 32))
      __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32 registers) += A (64 x 16, K-major) * B (16 x 128, read
// transposed: N-major in shared memory); imm-trans-b = 1
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_chain_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_b0,
                    const __grid_constant__ CUtensorMap map_b1,
                    const __grid_constant__ CUtensorMap map_w, bf16* buf0, bf16* buf1, bf16* out,
                    int T, int D, int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // 128-byte swizzled tiles need 1024-byte aligned stages
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const int tiles_n = D / BN;
  const int n_tiles = ((T + BM - 1) / BM) * tiles_n;
  const int n_kb = D / BK;
  int stage = 0;
  uint32_t phase = 0;  // each role walks the ring in the same order

  for (int step = 0; step < k; ++step) {
    const CUtensorMap* src = step == 0 ? &map_x : (step % 2 ? &map_b0 : &map_b1);
    bf16* dst = step == k - 1 ? out : (step % 2 ? buf1 : buf0);
    if (tid >= kConsumers) {
      if (tid == kConsumers) {  // the producer: one thread issues every load
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
          const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
          for (int kb = 0; kb < n_kb; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* st = smem + stage * kStageBytes;
            mbar_expect_tx(&full[stage], kStageBytes);
            tma_load_2d(st, src, &full[stage], kb * BK, m0);
            const int krow = step * D + kb * BK;
            tma_load_2d(st + kABytes, &map_w, &full[stage], n0, krow);
            tma_load_2d(st + kABytes + kBHalfBytes, &map_w, &full[stage], n0 + 64, krow);
            if (++stage == kStages) stage = 0, phase ^= 1;
          }
        }
      }
    } else {  // the consumer warpgroup
      const int warp = tid / 32, lane = tid % 32;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int kb = 0; kb < n_kb; ++kb) {
          mbar_wait(&full[stage], phase);
          const uint8_t* st = smem + stage * kStageBytes;
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // A: +32 bytes per 16 k inside the swizzled 128-byte rows;
            // B: +16 k rows of 128 bytes; the two 64-column halves 8 KB apart
            const uint64_t da = smem_desc(st + 32 * kk, 16, 1024);
            const uint64_t db = smem_desc(st + kABytes + 2048 * kk, kBHalfBytes, 1024);
            wgmma_m64n128k16(acc, da, db, 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_acc(acc);
          mbar_arrive(&empty[stage]);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
        // round to bf16 (nearest even) and store: n8 block j of the
        // accumulator holds rows r, r + 8 and columns 8 j + 2 (lane % 4) + {0, 1}
        const int r = m0 + 16 * warp + lane / 4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + 2 * (lane % 4);
          if (r < T)
            *reinterpret_cast<__nv_bfloat162*>(dst + (int64_t)r * D + c) =
                __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          if (r + 8 < T)
            *reinterpret_cast<__nv_bfloat162*>(dst + (int64_t)(r + 8) * D + c) =
                __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      // the next product reads these stores through TMA on other SMs
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    if (step + 1 < k) grid.sync();  // every tile of this product is written
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix read in 64 x 64 boxes, 128B swizzle
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  CUtensorMap map_x, map_b0, map_b1, map_w;
  if (!make_map(&map_x, x, T, D) || !make_map(&map_b0, buf0, T, D) ||
      !make_map(&map_b1, buf1, T, D) || !make_map(&map_w, ws, k * D, D))
    return (int)cudaErrorInvalidValue;
  // the dynamic shared memory size is set before the occupancy query and
  // the cooperative launch, which both depend on it
  err = cudaFuncSetAttribute(matmul_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matmul_chain_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((T + BM - 1) / BM) * (D / BN);
  int grid = per_sm * sms;
  if (grid > n_tiles) grid = n_tiles;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  bf16* b0 = static_cast<bf16*>(buf0);
  bf16* b1 = static_cast<bf16*>(buf1);
  bf16* ob = static_cast<bf16*>(out);
  void* args[] = {&map_x, &map_b0, &map_b1, &map_w, &b0, &b1, &ob, &T, &D, &k};
  err = cudaLaunchCooperativeKernel((void*)matmul_chain_kernel, dim3(grid), dim3(kThreads), args,
                                    kSmemBytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* rtwa_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
