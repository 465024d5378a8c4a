// A small thread-level CUDA emulator: compiles the port's kernel sources
// (transformer_explainability_torch/csrc/*.cu) as plain C++ with g++ and runs
// them on the CPU, so that tests can hold the kernels themselves to their
// plain PyTorch versions on a machine without a GPU or nvcc.
//
// Scope: exactly what the sources use. Each block runs its threads as
// std::threads (blocks run one after another, so one dynamic shared-memory
// buffer serves them all); __syncthreads and __syncwarp are barriers;
// __shfl_xor_sync exchanges through a per-warp slot array between two warp
// barriers. A thread that returns early drops out of both barriers, as a
// finished CUDA thread no longer takes part in __syncthreads.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <math.h>
#include <memory>
#include <stdexcept>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
constexpr std::size_t kSmemLimit = 232448;   // sm_90 opt-in maximum
constexpr std::size_t kSmemBuffer = 1 << 20;

struct BlockCtx {
  std::barrier<>* block_bar;
  std::vector<std::unique_ptr<std::barrier<>>>* warp_bars;
  std::vector<double>* slots;
};
inline thread_local BlockCtx ctx;
}  // namespace emu

inline void __syncthreads() { emu::ctx.block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*emu::ctx.warp_bars)[threadIdx.x / 32]->arrive_and_wait();
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  auto& s = *emu::ctx.slots;
  s[w * 32 + l] = static_cast<double>(v);    // exact for float and double
  __syncwarp();
  T r = static_cast<T>(s[w * 32 + (l ^ lane_mask)]);
  __syncwarp();
  return r;
}

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = static_cast<int>(emu::kSmemLimit);
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return static_cast<std::size_t>(bytes) > emu::kSmemLimit
             ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument (emulated)";
}

extern unsigned char te_smem[];

namespace emu {
template <typename... KArgs>
struct Launch {
  void (*kernel)(KArgs...);
  dim3 grid, block;
  std::size_t smem;

  template <typename... Args>
  void operator()(Args... args) const {
    if (smem > kSmemBuffer) throw std::runtime_error("shared memory");
    const unsigned nthreads = block.x * block.y * block.z;
    const unsigned nwarps = (nthreads + 31) / 32;
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          std::barrier<> bar(nthreads);
          std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
          for (unsigned w = 0; w < nwarps; ++w)
            warp_bars.emplace_back(
                new std::barrier<>(std::min(32u, nthreads - 32 * w)));
          std::vector<double> slots(nwarps * 32);
          std::vector<std::thread> threads;
          for (unsigned t = 0; t < nthreads; ++t) {
            threads.emplace_back([&, t]() {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                               t / (block.x * block.y));
              blockIdx = dim3(bx, by, bz);
              blockDim = block;
              gridDim = grid;
              ctx = BlockCtx{&bar, &warp_bars, &slots};
              kernel(args...);
              warp_bars[t / 32]->arrive_and_drop();
              bar.arrive_and_drop();
            });
          }
          for (auto& th : threads) th.join();
        }
  }
};

template <typename... KArgs>
Launch<KArgs...> launch(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                        std::size_t smem) {
  return Launch<KArgs...>{kernel, grid, block, smem};
}
}  // namespace emu

#define TE_LAUNCH(kernel, grid, block, smem, stream) \
  emu::launch(kernel, dim3(grid), dim3(block), static_cast<std::size_t>(smem))
