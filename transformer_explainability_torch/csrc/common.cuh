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
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

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

// bf16 values travel as their raw 16 bits (uint16_t). The conversions and
// the tensor-core product sit behind these small functions so that the
// sources also compile as plain C++ against tests/cuda_emulator, which
// gives each a plain counterpart.
__device__ __forceinline__ uint16_t f2bf(float x) {   // round to nearest even
#ifdef __CUDACC__
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
#else
  return te_emu_f2bf(x);
#endif
}

__device__ __forceinline__ float bf2f(uint16_t u) {
#ifdef __CUDACC__
  return __uint_as_float((uint32_t)u << 16);
#else
  return te_emu_bf2f(u);
#endif
}

// x rounded to bf16 and back (the operand of a one-pass bf16 product)
__device__ __forceinline__ float round_bf16(float x) { return bf2f(f2bf(x)); }

// Arithmetic the compiler may not contract into an FMA: the anchors that a
// forward and a reverse kernel both form (LayerNorm outputs, GELU) must come
// out bitwise equal in both.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// D += A·B on the tensor cores: one m16n8k16 tile, bf16 operands packed two
// to a register in the PTX fragment layout, float32 accumulators. A
// warp-collective operation: all 32 lanes call it together.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
#ifdef __CUDACC__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  te_emu_mma_bf16_16816(d, a, b);
#endif
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
