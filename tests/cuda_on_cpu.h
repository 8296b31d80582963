// Stand-ins for the CUDA constructs a simple kernel source uses, so that the
// source compiles with a host C++20 compiler and runs on the CPU: one
// std::thread per CUDA thread, a std::barrier per block for __syncthreads,
// __shared__ arrays as function statics (shared by the block's threads),
// and blocks run one after another. A launch `kernel<<<grid, threads, 0,
// stream>>>(args)` is rewritten by the test to `emulate_launch(grid, threads,
// kernel, args)`. Arithmetic is the host's: no FMA contraction is promised.
#pragma once

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>

using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(x)
#define __align__(x)

struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }

struct emulated_dim3 {
  int x;
};
inline thread_local emulated_dim3 threadIdx, blockIdx;
inline std::barrier<>* emulated_block_barrier;
inline void __syncthreads() { emulated_block_barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t err) {
  return err == cudaSuccess ? "no error" : "invalid argument";
}

template <class Kernel, class... Args>
void emulate_launch(int grid, int threads, Kernel kernel, Args... args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> barrier(threads);
    emulated_block_barrier = &barrier;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}
