// Packed-int4 linear for Hopper (sm_90a): the whole int4 branch of the JAX
// package's model._linear in at most two launches.
//
// Replaces realtime_whisper_asr_tpu/ops/int4_matmul.py::_kernel (the Pallas
// TPU kernel launched by int4_matmul) and, on the card, the XLA grouped-int32
// formulation of model._linear's int4 branch with the activation
// quantization around it: every int4 product of the "int4" / "int4-all"
// tiers (decode steps at M = 1, prefill spans, the cross-K/V projection at
// M = 400 / 800 / 1500) comes here.
//
//   x  (M, K) activations: int8 (int4_matmul, already quantized) or f32 /
//      bf16 (int4_linear, quantized here)
//   wp (K/2, N) int8: two int4 weights per byte, input row 2i in the low
//      nibble and 2i+1 in the high nibble (quant.pack_int4's layout)
//   s  (G, N) f32 scales, one per column per group of K/G input rows
//
// Two functions of one kernel family:
//   int4_matmul: y (M, N) f32 = sum over g, in order, of fl(float(P_g) * s_g),
//     P_g the exact int32 product of group g;
//   int4_linear: prologue sx = max(absmax(x_m) / 127, 1e-12) and
//     q = clamp(rint(x / sx), -127, 127) per row (IEEE divide, round half to
//     even), the same product, epilogue fl(y * sx) cast to x's dtype, then
//     the bias added as torch adds it (bf16(fl32(bf16(y) + b)) at bf16).
// Integer sums are exact and every float step is one rounded operation in a
// fixed order (__fdiv_rn, rintf, __fmul_rn, __fadd_rn, no contraction), so
// the plain version (ops/int4_matmul.py) agrees bit for bit. Build without
// --use_fast_math: the exactness depends on IEEE '/' and rintf.
//
// Unpacking: a byte's low nibble shifted up by 4, and its high nibble masked
// in place, are 16 * w as int8 (|16 w| <= 112), with no sign extension; a
// __byte_perm pair turns two packed rows into the k-contiguous int8 words of
// four columns. Products of 16 w sum exactly in int32 and an arithmetic
// shift by 4 gives the true group sum.
//
// Decode regime (M <= 8): bytes bound it (the packed weights, K/2 * N, and
// the scales over 3.35 TB/s: 0.26-1.05 us at large-v3's shapes), and the
// latency of the loads behind them. One launch, no workspace: a block owns
// 32 columns over all of K (40-160 blocks at large-v3's shapes), each warp
// a set of chunks of <= 128 input rows (one group). The loads of a warp's
// next two chunks of the packed slice (two 16-byte loads per packed row
// pair, eight per thread; K = 5120's 40 chunks take two rounds of 16 warps)
// and of the tile's scales are issued before anything waits (five chunks
// at once spilled registers at 2-8 rows; three and five were slower at all
// shapes but M = 1, K = 5120); the
// block reads the activation rows (from L2) for their absmax meanwhile, and
// each lane quantizes its own inputs and sums with __dp4a. A chunk's sums
// are reduced over 16 lanes by a 15-shuffle reduce-scatter (in registers:
// compile-time indices only) into shared memory, and the block adds the
// groups in order and applies the epilogue. Its shared arrays hold at most
// 40 chunks: K <= 5120 at 128-row groups (shape_ok refuses more).
//
// Prefill / cross-K/V regime (M > 8): int8 operations bound it on paper
// (2 M K N over 1,979 TOP/s is 1.3 us at M = 800, K = N = 1280, beside
// 1.8 us of bytes), but the unpack of the 4-bit weights and the per-group
// fold are ALU work that the tensor cores cannot take, and each of a
// column tile's row tiles repeats the unpack. int4_linear quantizes the
// rows in a first launch (one block per row); the product is a second launch
// with programmatic stream serialization, so its blocks start and load
// their first weight slices while the rows are being quantized. It runs on
// the int8 tensor cores with wgmma m64n64k32 on 64 x 64 tiles, two blocks
// per SM, each block warp-specialized: a producer warpgroup loads 128-row
// k slices (cp.async, three ahead, into a 4-stage ring; the activations
// straight into the 128-byte-swizzled K-major layout wgmma reads) and
// unpacks each into K-major int8 (per thread 4 columns x 16 inputs: eight
// 4-byte reads, four 16-byte stores, swizzled on both sides so that no
// access has a bank conflict); a consumer warpgroup takes each slice from
// a full barrier, runs the products, folds and hands the stage back on an
// empty barrier. So the unpack and the loads run beside the products and
// the fold instead of between them. A group's first k step starts its
// int32 accumulators from zero (scale-d 0); at its end they fold into the
// f32 outputs in group order, each sum turned into f32 exactly by
// exact_i2f's two full-rate operations (groups of at most 4096 rows keep
// it below 2^22). Two accumulator sets in one warpgroup, one group folding
// while the next runs, made ptxas serialize every wgmma (C7514) and were
// slower; so were 64 x 128 tiles of two warpgroups in lockstep.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDecodeMaxM = 8;
constexpr int kChunk = 128;   // input rows of one decode chunk (at most)

// ------------------------------------------------------------ helpers

// eight consecutive activations as f32 (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
// four consecutive activations as f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// the activation scale of a row from its absmax, as quantize_rows computes it
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
}
// clamp(rint(v / sx), -127, 127) as an int8 in the low byte
__device__ __forceinline__ uint32_t quant8(float v, float sx) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu;
}

// Two packed rows (r0 holds k = 4i, 4i+1 in its nibbles, r1 holds 4i+2,
// 4i+3), four columns (one per byte) -> per column the int8 word of
// 16 * w[4i .. 4i+3], lowest k in the lowest byte.
__device__ __forceinline__ void unpack4(uint32_t r0, uint32_t r1, uint32_t b[4]) {
  const uint32_t l0 = (r0 << 4) & 0xF0F0F0F0u, h0 = r0 & 0xF0F0F0F0u;
  const uint32_t l1 = (r1 << 4) & 0xF0F0F0F0u, h1 = r1 & 0xF0F0F0F0u;
  const uint32_t p = __byte_perm(l0, h0, 0x5140), q = __byte_perm(l0, h0, 0x7362);
  const uint32_t u = __byte_perm(l1, h1, 0x5140), v = __byte_perm(l1, h1, 0x7362);
  b[0] = __byte_perm(p, u, 0x5410);
  b[1] = __byte_perm(p, u, 0x7632);
  b[2] = __byte_perm(q, v, 0x5410);
  b[3] = __byte_perm(q, v, 0x7632);
}

// the epilogue: fl(y * sx) when scaled (int4_linear; int4_matmul's output
// is the raw f32 sum), the cast to the output type, then the bias when given,
// added as torch adds it in that type
__device__ __forceinline__ float epilogue(float y, bool scaled, float sx, bool biased, float b) {
  if (scaled) y = __fmul_rn(y, sx);
  return biased ? __fadd_rn(y, b) : y;
}
__device__ __forceinline__ bf16 epilogue(float y, bool scaled, float sx, bool biased, bf16 b) {
  const bf16 r = __float2bfloat16_rn(scaled ? __fmul_rn(y, sx) : y);
  return biased ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), __bfloat162float(b))) : r;
}

// One step of a reduce-scatter of 16 sums over lane bits: lanes that differ
// in bit 2H exchange halves, each keeps the H sums of its half (compile-time
// indices keep acc in registers)
template <int H>
__device__ __forceinline__ void reduce_scatter_step(int32_t (&acc)[16], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int32_t send = upper ? acc[i] : acc[i + H];
    acc[i] = (upper ? acc[i + H] : acc[i]) + __shfl_xor_sync(0xFFFFFFFFu, send, 2 * H);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// ------------------------------------------------------ decode (M <= 8)

constexpr int kDecCols = 32;        // output columns of a decode block
constexpr int kDecGroups = kDecCols / 16;      // 16-column groups: one 16-byte load each
constexpr int kDecRowLanes = 32 / kDecGroups;  // lanes along k in a warp
static_assert(kDecRowLanes == 16, "the reduce-scatter below spans lane bits 4 .. 1");
constexpr int kDecMaxChunks = 40;   // K <= 40 chunks of 128 rows
constexpr int kDecMaxWarps = 16;    // warps of a decode block: one per chunk, at most 16
constexpr int kDecBatch = 2;        // chunks whose loads a warp issues at once

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grid (N / kDecCols), blockDim min(16, K / KC) warps. Warp w takes the
// chunks c = w, w + W, ... of KC <= 128 input rows (one group, or a slice of
// one). Lane (r, cg) = (lane / kDecGroups, lane % kDecGroups) takes 16
// columns (one 16-byte load per packed row; neighbouring lanes read one
// row's consecutive bytes) and packed rows 2q, 2q+1 (inputs 4q .. 4q+3) for
// q = r, r + kDecRowLanes, ... of the chunk. A chunk's exact sums are
// reduced over the lanes of each column group into shared memory; the
// block then sums the groups in order.
template <typename TIn, typename TOut, int MT>
__global__ void __launch_bounds__(32 * kDecMaxWarps)
k2_decode(const TIn* __restrict__ x, const int8_t* __restrict__ wp, const float* __restrict__ s,
          const TOut* __restrict__ bias, TOut* __restrict__ y, int M, int K, int N, int G,
          int kc) {
  constexpr bool kQuant = !std::is_same<TIn, int8_t>::value;
  constexpr int kPairs = 32 / kDecRowLanes;  // row pairs of a lane in a 128-row chunk
  __shared__ float s_max[kDecMaxWarps][MT];
  __shared__ int32_t s_part[MT][kDecMaxChunks][kDecCols];  // chunk sums
  __shared__ __align__(16) float s_scale[kDecMaxChunks][kDecCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5, n_threads = blockDim.x;
  const int rl = lane / kDecGroups, cg = lane % kDecGroups;
  const int n0 = blockIdx.x * kDecCols;
  const int n_chunks = K / kc;
  const bool col_ok = n0 + 16 * cg < N;  // N % 16 == 0: the 16 columns or none

  // 1. every load this block needs before it can finish, in flight at
  //    once: the packed slices of the warp's first chunks, the tile's group
  //    scales (cp.async into shared memory) and the bias of step 4's column
  uint4 w[kDecBatch][kPairs][2];
  auto load_batch = [&](int c0) {
#pragma unroll
    for (int b = 0; b < kDecBatch; ++b)
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int c = c0 + n_warps * b, q = rl + kDecRowLanes * p;
        w[b][p][0] = w[b][p][1] = make_uint4(0, 0, 0, 0);
        if (c < n_chunks && 4 * q < kc && col_ok) {
          const int8_t* ptr = wp + (int64_t)(c * kc / 2 + 2 * q) * N + n0 + 16 * cg;
          w[b][p][0] = __ldg(reinterpret_cast<const uint4*>(ptr));
          w[b][p][1] = __ldg(reinterpret_cast<const uint4*>(ptr + N));
        }
      }
  };
  load_batch(warp);
  for (int i = tid; i < G * kDecCols / 4; i += n_threads) {
    const int g = i / (kDecCols / 4), c = 4 * (i % (kDecCols / 4));
    const bool ok = n0 + c < N;
    cp_async16(&s_scale[g][c], ok ? s + (int64_t)g * N + n0 + c : s, ok ? 16 : 0);
  }
  cp_async_commit();
  TOut b_out[(MT * kDecCols + 31) / 32];  // step 4's bias values
#pragma unroll
  for (int j = 0; j < (MT * kDecCols + 31) / 32; ++j) {
    const int i = tid + j * n_threads, n = n0 + i % kDecCols;
    b_out[j] = (bias && i < MT * kDecCols && n < N) ? bias[n] : TOut{};
  }

  // 2. the activation scale of each row: absmax over the whole row (L2),
  //    each warp over a slice, then every thread over the warps' maxima
  float sx[MT];
  if constexpr (kQuant) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float a = 0.f;
      if (m < M) {
        const TIn* row = x + (int64_t)m * K;
#pragma unroll 4
        for (int i = 8 * tid; i < K; i += 8 * n_threads) {
          float v[8];
          load8(row + i, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(v[e]));
        }
      }
      a = warp_max(a);
      if (lane == 0) s_max[warp][m] = a;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float a = 0.f;
      for (int v = 0; v < n_warps; ++v) a = fmaxf(a, s_max[v][m]);
      sx[m] = row_scale(a);
    }
  }

  // 3. per chunk and row: the lane's inputs quantized, exact sums of 16 w x
  //    over them, then a reduce-scatter over the column group's lanes:
  //    lane (r, cg) ends with column 16 cg + r % 16's chunk sum
  for (int c0 = warp; c0 < n_chunks; c0 += n_warps * kDecBatch) {
    if (c0 != warp) load_batch(c0);
#pragma unroll
    for (int b = 0; b < kDecBatch; ++b) {
      const int c = c0 + n_warps * b;
      if (c >= n_chunks) break;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        int32_t acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const int q = rl + kDecRowLanes * p;
          uint32_t xw = 0;
          if (4 * q < kc) {
            const int k = c * kc + 4 * q;
            if constexpr (kQuant) {
              float v[4];
              load4(x + (int64_t)m * K + k, v);
              xw = quant8(v[0], sx[m]) | quant8(v[1], sx[m]) << 8 | quant8(v[2], sx[m]) << 16 |
                   quant8(v[3], sx[m]) << 24;
            } else {
              xw = *reinterpret_cast<const uint32_t*>(x + (int64_t)m * K + k);
            }
          }
          const uint32_t r0[4] = {w[b][p][0].x, w[b][p][0].y, w[b][p][0].z, w[b][p][0].w};
          const uint32_t r1[4] = {w[b][p][1].x, w[b][p][1].y, w[b][p][1].z, w[b][p][1].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bw[4];
            unpack4(r0[i], r1[i], bw);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[4 * i + j] = __dp4a((int)xw, (int)bw[j], acc[4 * i + j]);
          }
        }
        // over lane bits 4 .. 1 (bit 0 is the column group): the 16 lanes of
        // a group end with its 16 column sums, lane (r, cg) with column r
        reduce_scatter_step<8>(acc, lane);
        reduce_scatter_step<4>(acc, lane);
        reduce_scatter_step<2>(acc, lane);
        reduce_scatter_step<1>(acc, lane);
        s_part[m][c][16 * cg + rl] = acc[0] >> 4;  // exact: 16 x the sum
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. the groups in order, scaled, then the epilogue
  const int cpg = (K / G) / kc;  // chunks per group
#pragma unroll
  for (int j = 0; j < (MT * kDecCols + 31) / 32; ++j) {
    const int i = tid + j * n_threads;
    const int m = i / kDecCols, c = i % kDecCols, n = n0 + c;
    if (i >= MT * kDecCols || m >= M || n >= N) continue;
    float sxm = 1.f;  // the row's scale, from a register (m is not a constant here)
    if constexpr (kQuant) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (r == m) sxm = sx[r];
    }
    float out = 0.f;
    if (cpg == 1) {
#pragma unroll 8
      for (int g = 0; g < G; ++g)
        out = __fadd_rn(out, __fmul_rn((float)s_part[m][g][c], s_scale[g][c]));
    } else {
      for (int g = 0; g < G; ++g) {
        int32_t p = 0;
        for (int k = 0; k < cpg; ++k) p += s_part[m][g * cpg + k][c];
        out = __fadd_rn(out, __fmul_rn((float)p, s_scale[g][c]));
      }
    }
    y[(int64_t)m * N + n] = epilogue(out, kQuant, sxm, bias, b_out[j]);
  }
}

// -------------------------------------------------- prefill: quantize

// one block per row, a thread per 8 inputs (K / 8 threads, at most 1024):
// sx = max(absmax / 127, 1e-12) and xq = clamp(rint(x / sx), -127, 127).
// A thread keeps its first 8 inputs in registers between the two passes
// and reads any others again (from L1). The product's launch behind it may
// start at once (its blocks wait for this grid before they read xq).
constexpr int kQuantMaxThreads = 1024;

int quant_threads(int K) {
  const int t = (K / 8 + 31) / 32 * 32;
  return t < kQuantMaxThreads ? t : kQuantMaxThreads;
}

template <typename TIn>
__global__ void __launch_bounds__(kQuantMaxThreads)
k2_quantize(const TIn* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float s_max[kQuantMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, stride = 8 * blockDim.x;
  const TIn* row = x + (int64_t)blockIdx.x * K;
  float v0[8] = {}, a = 0.f;
  if (8 * tid < K) load8(row + 8 * tid, v0);
#pragma unroll
  for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(v0[e]));
  for (int i = 8 * tid + stride; i < K; i += stride) {
    float v[8];
    load8(row + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(v[e]));
  }
  a = warp_max(a);
  if (lane == 0) s_max[warp] = a;
  __syncthreads();
  a = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) a = fmaxf(a, s_max[w]);
  const float scale = row_scale(a);
  if (tid == 0) sx[blockIdx.x] = scale;
  int8_t* out = xq + (int64_t)blockIdx.x * K;
  auto store8 = [&](int i, const float (&v)[8]) {
    uint2 u;
    u.x = quant8(v[0], scale) | quant8(v[1], scale) << 8 | quant8(v[2], scale) << 16 |
          quant8(v[3], scale) << 24;
    u.y = quant8(v[4], scale) | quant8(v[5], scale) << 8 | quant8(v[6], scale) << 16 |
          quant8(v[7], scale) << 24;
    *reinterpret_cast<uint2*>(out + i) = u;
  };
  if (8 * tid < K) store8(8 * tid, v0);
  for (int i = 8 * tid + stride; i < K; i += stride) {
    float v[8];
    load8(row + i, v);
    store8(i, v);
  }
}

// ------------------------------------------ prefill: int8 tensor cores

constexpr int kWThreads = 128;                     // a warpgroup: consumer, producer
constexpr int kWM = 64, kWN = 64, kWK = 128;       // tile rows, tile columns, k slice
constexpr int kWStages = 4;                        // ring depth
constexpr int kWMaxGroup = 4096;                   // input rows of a group, at most
constexpr int kWA = kWM * kWK;                     // activation slice, 128-byte rows
constexpr int kWRaw = kWK / 2 * 128;               // packed weight slice, 128-byte rows (kWN used)
constexpr int kWU = kWN * kWK;                     // the unpacked weight slice
constexpr int kWS = kWK / 32 * kWN * 4;            // scales of the groups ending in a slice
constexpr int kWStage = kWA + kWRaw + kWU + kWS;   // a multiple of 1024
// dynamic: alignment slack, the stages, a full and an empty barrier each
constexpr int kWSmem = 1024 + kWStages * kWStage + 2 * kWStages * 8;
static_assert(kWStage % 1024 == 0, "128-byte swizzled tiles sit on 1024-byte boundaries");
static_assert(2 * (kWSmem + 1024) <= 228 * 1024, "two blocks share an SM");

// int32 v with |v| < 2^22 as f32, exactly, in two full-rate operations (the
// conversion instruction issues at an eighth of the f32 rate): the bits of
// 1.5 * 2^23 plus v are the float 1.5 * 2^23 + v
__device__ __forceinline__ float exact_i2f(int32_t v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of parity `parity` has completed. A slice that
// never arrives traps after ~2 s instead of hanging the card.
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

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle: start address, stride between 8-row groups (1024
// bytes), layout type 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
// byte offset of (row, k byte) in a tile of 128-byte rows, 128-byte swizzle:
// the 16-byte chunk index is XORed with the row's index within its 8 rows
__device__ __forceinline__ int sw128(int row, int kb) {
  return row * 128 + ((((kb >> 4) ^ row) & 7) << 4) + (kb & 15);
}
// byte offset of (packed row, byte) in the ring's packed weight slice: the
// 16-byte chunk index is XORed with the row's eighth, so that the unpack's
// reads of eight rows 8 apart hit 32 banks
__device__ __forceinline__ int raw_off(int row, int b) {
  return row * 128 + ((((b >> 4) ^ (row >> 3)) & 7) << 4) + (b & 15);
}

// D (64 x 64 int32, registers) (+)= A (64 x 32 int8) * B (32 x 64 int8),
// both K-major in shared memory; scale_d = 0 starts from zero
__device__ __forceinline__ void wgmma_s8_m64n64k32(int32_t (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Grid (N/64, M/64), two warpgroups a block and two blocks an SM. The
// producer warpgroup (warps 4-7) brings each 128-row k slice's activations
// (cp.async, straight into the swizzled layout wgmma reads), packed weights
// (raw_off's layout) and group scales into a 4-stage ring, three slices
// ahead, and unpacks each landed slice into the stage's K-major int8
// buffer (16 w; each thread 4 columns x 16 inputs: eight 4-byte reads,
// four unpack4, four 16-byte stores, none with a bank conflict), then
// arrives on the stage's full barrier. The consumer warpgroup (warps 0-3)
// waits on it, runs wgmma m64n64k32 per 32-row k step, folds each finished
// group into the f32 outputs, in order, and arrives on the stage's empty
// barrier, which the producer waits on before it refills the stage. So the
// unpack and the loads of later slices run while the consumer's products
// and folds do, and a block's two roles never wait on a block barrier. A
// group's first step starts its int32 accumulators from zero.
template <typename TOut>
__global__ void __launch_bounds__(2 * kWThreads, 2)
k2_wgmma(const int8_t* __restrict__ xq, const int8_t* __restrict__ wp,
         const float* __restrict__ s, const float* __restrict__ sx,
         const TOut* __restrict__ bias, TOut* __restrict__ y, int M, int K, int N, int G) {
  // 128-byte swizzled tiles sit on 1024-byte boundaries; offsetting the
  // shared array itself (not a cast integer) keeps every access an LDS/STS
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto stage_a = [&](int st) { return smem + st * kWStage; };
  auto stage_raw = [&](int st) { return smem + st * kWStage + kWA; };
  auto stage_u = [&](int st) { return smem + st * kWStage + kWA + kWRaw; };
  auto stage_s = [&](int st) {
    return reinterpret_cast<float*>(smem + st * kWStage + kWA + kWRaw + kWU);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStage);
  uint64_t* empty = full + kWStages;

  const int tid = threadIdx.x % kWThreads, lane = tid & 31, warp = tid >> 5;
  const bool producer = threadIdx.x >= kWThreads;
  const int m0 = blockIdx.y * kWM, n0 = blockIdx.x * kWN;
  const int gs = K / G, spg = gs / 32;  // k steps per group
  const int n_kt = (K + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(&full[st], kWThreads);
      mbar_init(&empty[st], kWThreads);
    }
  }
  __syncthreads();

  if (producer) {
    // each thread's copies, fixed over the k loop: four 16-byte chunks of
    // the activation slice (64 rows x 128 bytes), two of the packed weight
    // slice (64 rows x 64 bytes), and for the first 16 threads 4 scales of
    // each group that ends in the slice
    const int8_t* a_src[4];
    int a_dst[4], ar[4], ac[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kWThreads;
      ar[i] = c >> 3;
      ac[i] = (c & 7) * 16;
      a_src[i] = xq + (int64_t)(m0 + ar[i] < M ? m0 + ar[i] : 0) * K + ac[i];
      a_dst[i] = sw128(ar[i], ac[i]);
    }
    const int br = tid >> 2, bc = (tid & 3) * 16;  // and br + 32
    const bool b_col_ok = n0 + bc < N, s_ok = n0 + 4 * tid < N;
    const int8_t* b_src = wp + (int64_t)br * N + (b_col_ok ? n0 + bc : 0);
    const float* s_src = s + (s_ok ? n0 + 4 * tid : 0);
    int ld_step = 0, ld_group = 0;  // the loading side's place in the groups
    auto load_a = [&](int st, int kt) {  // activations
      const int k0 = kt * kWK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = m0 + ar[i] < M && k0 + ac[i] < K;
        cp_async16(stage_a(st) + a_dst[i], ok ? a_src[i] + k0 : xq, ok ? 16 : 0);
      }
    };
    auto load_w = [&](int st, int kt) {  // packed weights and group scales
      const int k0 = kt * kWK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = br + 32 * i;
        const bool ok = b_col_ok && k0 / 2 + r < K / 2;
        cp_async16(stage_raw(st) + raw_off(r, bc),
                   ok ? b_src + (int64_t)(k0 / 2 + 32 * i) * N : wp, ok ? 16 : 0);
      }
#pragma unroll
      for (int ks = 0; ks < kWK / 32; ++ks) {
        if (k0 + 32 * ks >= K || ++ld_step < spg) continue;
        ld_step = 0;
        if (tid < kWN / 4)
          cp_async16(stage_s(st) + ks * kWN + 4 * tid,
                     s_ok ? s_src + (int64_t)ld_group * N : s, s_ok ? 16 : 0);
        ++ld_group;
      }
    };
    // this thread's unpack: columns 4 c4 .. 4 c4 + 3 (one 4-byte word of
    // each packed row, c4 < 16) and inputs 16 kq .. 16 kq + 15 (packed rows
    // 8 kq .. 8 kq + 7). Eight lanes of one c4 store its columns' 16-byte
    // chunks kq = 0 .. 7: 32 banks a phase.
    const int kq = lane & 7, c4 = (lane >> 3) + 4 * warp;
    const int raw_base = raw_off(8 * kq, 4 * c4);
    auto unpack = [&](int st) {
      const uint8_t* raw = stage_raw(st) + raw_base;
      uint8_t* u = stage_u(st);
      uint32_t r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = *reinterpret_cast<const uint32_t*>(raw + 128 * i);
      uint32_t b[4][4];  // [4 inputs][column]
#pragma unroll
      for (int p = 0; p < 4; ++p) unpack4(r[2 * p], r[2 * p + 1], b[p]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint4*>(u + sw128(4 * c4 + j, 16 * kq)) =
            make_uint4(b[0][j], b[1][j], b[2][j], b[3][j]);
    };

    // the first slices' weights do not depend on the launch before (the
    // row quantization); their activations do
    constexpr int kAhead = kWStages - 1;
#pragma unroll
    for (int kt = 0; kt < kAhead; ++kt)
      if (kt < n_kt) load_w(kt, kt);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int kt = 0; kt < kAhead; ++kt) {
      if (kt < n_kt) load_a(kt, kt);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kWStages;
      cp_async_wait<kAhead - 1>();  // this thread's copies of slice kt
      asm volatile("bar.sync 1, %0;\n" ::"n"(kWThreads) : "memory");  // everyone's
      unpack(st);
      // the copies and the unpacked slice, for wgmma's (async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[st]);
      const int next = kt + kAhead;  // into the stage slice kt - 1 used
      if (next < n_kt) {
        if (kt >= 1) mbar_wait(&empty[(kt - 1) % kWStages], ((kt - 1) / kWStages) & 1);
        load_w(next % kWStages, next);
        load_a(next % kWStages, next);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  // the consumer. The epilogue's operands: rows 16 warp + lane / 4 (+ 8),
  // columns 8 j + 2 (lane % 4) (+ 1) of the tile
  const int row0 = m0 + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  TOut bv[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[2 * j + e] = (bias && col0 + 8 * j < N) ? bias[col0 + 8 * j + e] : TOut{};
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float sxr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sxr[h] = (sx && row0 + 8 * h < M) ? __ldg(sx + row0 + 8 * h) : 1.f;

  int32_t acc[32];
  float out[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0, out[i] = 0.f;
  // fold the group whose scales sit in slot ks of stage st into out, in order
  auto fold = [&](int st, int ks) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    const float* sc = stage_s(st) + ks * kWN + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 sj = *reinterpret_cast<const float2*>(sc + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __fmul_rn(exact_i2f(acc[4 * j + e] >> 4), (e & 1) ? sj.y : sj.x);
        out[4 * j + e] = __fadd_rn(out[4 * j + e], v);
      }
    }
  };

  int step = 0;  // k steps into the group
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kWStages;
    mbar_wait(&full[st], (kt / kWStages) & 1);
    const uint8_t* a_s = stage_a(st);
    const uint8_t* b_s = stage_u(st);
    int pending = -1;  // a group that ends with the slice
#pragma unroll
    for (int ks = 0; ks < kWK / 32; ++ks) {
      if (kt * kWK + 32 * ks >= K) break;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_s8_m64n64k32(acc, sw128_desc(a_s + 32 * ks), sw128_desc(b_s + 32 * ks),
                         step == 0 ? 0 : 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (++step < spg) continue;
      step = 0;
      if (ks == kWK / 32 - 1 || kt * kWK + 32 * ks + 32 >= K) {
        pending = ks;
      } else {  // a group inside the slice: its products first, then the fold
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fold(st, ks);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (pending >= 0) fold(st, pending);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + 8 * j;
      if (c >= N) continue;
      const TOut v0 = epilogue(out[4 * j + 2 * h], sx, sxr[h], bias, bv[2 * j]);
      const TOut v1 = epilogue(out[4 * j + 2 * h + 1], sx, sxr[h], bias, bv[2 * j + 1]);
      TOut* dst = y + (int64_t)m * N + c;
      if constexpr (sizeof(TOut) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(dst) =
            (uint32_t)__bfloat16_as_ushort(v0) | (uint32_t)__bfloat16_as_ushort(v1) << 16;
      }
    }
  }
}

// ------------------------------------------------------------ launch

int chunk_rows(int K, int G) {
  const int gs = K / G;
  return gs < kChunk ? gs : kChunk;
}

// The shapes the kernels take; the entry points refuse any other with
// cudaErrorInvalidValue before they launch anything: N % 16 == 0; K/G a
// multiple of 32 that is at most 128 or a multiple of 128; at M <= 8 at
// most kDecMaxChunks chunks of min(K/G, 128) input rows (k2_decode's shared
// arrays; K <= 5120 at 128-row groups), above 8 rows K/G <= kWMaxGroup
// (exact_i2f's range); x, wp and s 16-byte aligned.
bool shape_ok(const void* x, const int8_t* wp, const float* s, int M, int K, int N, int G) {
  if (M < 1 || K < 1 || N < 1 || G < 1 || K % G) return false;
  const int gs = K / G;
  if (N % 16 || gs % 32 || (gs > kChunk && gs % kChunk)) return false;
  if (M <= kDecodeMaxM && K / chunk_rows(K, G) > kDecMaxChunks) return false;
  if (M > kDecodeMaxM && gs > kWMaxGroup) return false;
  return ((uintptr_t)x | (uintptr_t)wp | (uintptr_t)s) % 16 == 0;
}

template <typename TIn, typename TOut>
void launch_decode(const TIn* x, const int8_t* wp, const float* s, const TOut* bias, TOut* y,
                   int M, int K, int N, int G, cudaStream_t stream) {
  const int kc = chunk_rows(K, G);
  const dim3 grid((N + kDecCols - 1) / kDecCols);
  const int warps = K / kc < kDecMaxWarps ? K / kc : kDecMaxWarps;
  const dim3 block(32 * warps);
  if (M <= 1)
    k2_decode<TIn, TOut, 1><<<grid, block, 0, stream>>>(x, wp, s, bias, y, M, K, N, G, kc);
  else if (M <= 2)
    k2_decode<TIn, TOut, 2><<<grid, block, 0, stream>>>(x, wp, s, bias, y, M, K, N, G, kc);
  else if (M <= 4)
    k2_decode<TIn, TOut, 4><<<grid, block, 0, stream>>>(x, wp, s, bias, y, M, K, N, G, kc);
  else
    k2_decode<TIn, TOut, 8><<<grid, block, 0, stream>>>(x, wp, s, bias, y, M, K, N, G, kc);
}

// after_quantize: launched behind k2_quantize on the same stream with
// programmatic stream serialization, so that its blocks start and load
// their first weight slices while the rows are still being quantized
template <typename TOut>
void launch_mma(const int8_t* xq, const int8_t* wp, const float* s, const float* sx,
                const TOut* bias, TOut* y, int M, int K, int N, int G, bool after_quantize,
                cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed first (a
  // failure shows as the launch's error)
  static const cudaError_t attr = cudaFuncSetAttribute(
      k2_wgmma<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  (void)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kWN - 1) / kWN, (M + kWM - 1) / kWM);
  cfg.blockDim = dim3(2 * kWThreads);
  cfg.dynamicSmemBytes = kWSmem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = after_quantize ? 1 : 0;
  cudaLaunchKernelEx(&cfg, k2_wgmma<TOut>, xq, wp, s, sx, bias, y, M, K, N, G);
}

template <typename T>
void launch_linear(const T* x, const int8_t* wp, const float* s, const T* bias, T* y, void* work,
                   int M, int K, int N, int G, cudaStream_t stream) {
  if (M <= kDecodeMaxM) {
    launch_decode<T, T>(x, wp, s, bias, y, M, K, N, G, stream);
    return;
  }
  int8_t* xq = static_cast<int8_t*>(work);
  float* sx = reinterpret_cast<float*>(xq + (((int64_t)M * K + 15) / 16) * 16);
  k2_quantize<T><<<M, quant_threads(K), 0, stream>>>(x, xq, sx, K);
  launch_mma<T>(xq, wp, s, sx, bias, y, M, K, N, G, true, stream);
}

}  // namespace

// Both entry points check the shapes (shape_ok), launch on `stream`
// (PyTorch's current stream) without synchronising and return
// cudaGetLastError(). The caller checks the types. For int4_linear at
// M > 8, `work` holds the quantized rows (M x K int8, padded to 16 bytes)
// and then M f32 row scales; it is unused below.

// int8 xq (M, K) -> f32 y (M, N); one launch
extern "C" int rtwa_int4_matmul(const int8_t* xq, const int8_t* wp, const float* s, float* y,
                                int M, int K, int N, int G, int device, void* stream) {
  if (!shape_ok(xq, wp, s, M, K, N, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= kDecodeMaxM)
    launch_decode<int8_t, float>(xq, wp, s, nullptr, y, M, K, N, G, st);
  else
    launch_mma<float>(xq, wp, s, nullptr, nullptr, y, M, K, N, G, false, st);
  return (int)cudaGetLastError();
}

// f32 or bf16 x (M, K) -> y (M, N) in x's dtype, with an optional bias of
// that dtype; one launch for M <= 8, two above
extern "C" int rtwa_int4_linear(const void* x, int is_bf16, const int8_t* wp, const float* s,
                                const void* bias, void* y, void* work, int M, int K, int N, int G,
                                int device, void* stream) {
  if (!shape_ok(x, wp, s, M, K, N, G)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_linear<bf16>(static_cast<const bf16*>(x), wp, s, static_cast<const bf16*>(bias),
                        static_cast<bf16*>(y), work, M, K, N, G, st);
  else
    launch_linear<float>(static_cast<const float*>(x), wp, s, static_cast<const float*>(bias),
                         static_cast<float*>(y), work, M, K, N, G, st);
  return (int)cudaGetLastError();
}

extern "C" const char* rtwa_int4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
