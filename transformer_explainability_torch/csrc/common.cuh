// Shared device helpers for the hand-written Hopper kernels of the port.
//
// Every kernel is templated on the scalar type T (float, the main path; and
// double, which lets a check hold a kernel to its plain PyTorch version
// tightly: the safe-divide chains turn 1-ulp float differences into ~1e-3).
// Sums are taken in a fixed order (sequential loops and xor-butterfly warp
// reductions; no atomics), so every run is bitwise repeatable.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// The launch syntax sits behind a macro so that the sources also compile as
// plain C++ (host-side syntax checks without nvcc).
#ifndef TE_LAUNCH
#define TE_LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<(grid), (block), (smem), (stream)>>>
#endif

// Dynamic shared memory of every kernel in this library.
extern __shared__ __align__(16) unsigned char te_smem[];

namespace te {

constexpr int kWarp = 32;

// ops.relprop.safe_divide: den = b + eps, nudged to eps where that sum is
// exactly 0; the result is 0 wherever b == 0.
template <typename T>
__device__ __forceinline__ T safe_divide(T a, T b) {
  const T eps = T(1e-9);
  T den = b + eps;
  if (den == T(0)) den = eps;
  return b == T(0) ? T(0) : a / den;
}

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// Butterfly reductions: every lane ends with the same, bitwise identical
// value (each partial sum is formed from the same two operands).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Largest shared-memory block the current device grants after opt-in
// (232,448 bytes on sm_90).
inline int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace te

extern "C" const char* te_error_string(int code);
