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
#include <cudaTypedefs.h>   // CUtensorMap, PFN_cuTensorMapEncodeTiled
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

// an operand as a product of precision R takes it: bf16 (R) or unrounded;
// a double rounds through float, as ops/precision.py's kdot does
template <bool R, typename T>
__device__ __forceinline__ T rnd(T x) {
  return R ? T(round_bf16(float(x))) : x;
}

// Arithmetic the compiler may not contract into an FMA: the anchors that a
// forward and a reverse kernel both form (LayerNorm outputs, GELU) must come
// out bitwise equal in both.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// two floats rounded to bf16 and packed as one fragment register (lo in the
// low half, as the lower k index of the pair): one cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
#ifdef __CUDACC__
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
#else
  return (uint32_t)f2bf(lo) | (uint32_t)f2bf(hi) << 16;
#endif
}

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

// 16 bytes from device memory into shared memory without a trip through
// registers (cp.async, sm_80 and newer). A batch of copies is closed by
// cp_async_commit(); cp_async_wait<N>() waits until at most N batches are
// in flight, and a __syncthreads() after it lets the other threads read.
// The emulator copies at once and its commit and wait do nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDACC__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  __builtin_memcpy(dst, src, 16);
#endif
}

// 4 bytes the same way (cp.async.ca), for rows that are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#ifdef __CUDACC__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  __builtin_memcpy(dst, src, 4);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The shared-window address of a pointer into shared memory (the emulator:
// its offset in the emulated buffer).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
#ifdef __CUDACC__
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#else
  return te_emu_smem_u32(p);
#endif
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): the warpgroup's asynchronous tensor-core product. Four
// warps (128 threads, a warpgroup) issue it together; A comes from
// registers, B from shared memory through a matrix descriptor, the float32
// accumulators stay in registers. The emulator runs it at once as a
// collective of the warpgroup and decodes the descriptor by the PTX ISA's
// rules.
// ---------------------------------------------------------------------------

// Orders this warpgroup's register writes (A fragments, accumulators)
// before the wgmma that follow it.
__device__ __forceinline__ void wgmma_fence() {
#ifdef __CUDACC__
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

// Closes the wgmma issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
#ifdef __CUDACC__
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// Waits until at most N groups are in flight: their A registers and
// accumulators may then be touched, their shared memory rewritten.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
#ifdef __CUDACC__
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#endif
}

// A shared-memory matrix descriptor for the 128-byte swizzle (layout type
// 1): the operand lies in atoms of 8 rows × 128 bytes, 1024-byte aligned,
// in which the 16-byte chunk c of row r sits at chunk position c ^ r (the
// XOR of address bits 4-6 with bits 7-9). The start address, lbo and sbo
// are stored >> 4 in 14 bits each (bits 0-13, 16-29, 32-45; base offset
// 49-51 zero). For a 16-bit operand, element (n, k) of the k16 slice at
// start lies before the swizzle at
//   K-major (the B of x·Wᵀ; a row is 64 k of one n):
//     start + (n/8)·sbo + (n%8)·128 + (k/8)·16 + (k%8)·2   (lbo unused)
//   MN-major (wgmma's transposed B; a row is 64 n of one k):
//     start + (n/64)·lbo + (n%64)·2 + (k/8)·sbo + (k%8)·128
// (the PTX ISA's canonical layouts with 128-byte swizzling).
__host__ __device__ inline uint64_t wgmma_desc128(uint32_t start, uint32_t lbo,
                                                  uint32_t sbo) {
  return (uint64_t)((start >> 4) & 0x3FFFu) |
         (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | (uint64_t)1 << 62;
}

// d (64 × N float32 per warpgroup) += a (64 × 16 bf16, registers) · b (16 ×
// N bf16, descriptor): wgmma.mma_async m64nNk16 with float32 accumulation.
// TB = 0 reads b K-major, 1 MN-major. Thread t of the warpgroup (warp w =
// t/32, g = (t%32)/4, q = t%4) holds in a[0..3] the bf16 pairs A(16w + g,
// 2q..2q+1), A(16w + g + 8, 2q..), A(16w + g, 2q + 8..), A(16w + g + 8, 2q +
// 8..), the lower k in the low half; and in d[4j + i] the element (16w + g +
// 8·(i/2), 8j + 2q + i%2). Issue between wgmma_fence() and wgmma_commit().
template <int N, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  static_assert(N == 64 || N == 128 || N == 192, "wgmma width");
#ifdef __CUDACC__
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
  }

#else
  te_emu_wgmma<N>(d, a, desc, TB);
#endif
}

// ---------------------------------------------------------------------------
// The Hopper pipeline pieces of the GEMM core (gemm.cuh): mbarriers in
// shared memory, the TMA's 2D tensor loads that complete on them, and the
// warpgroups' register budgets. The emulator gives each a plain counterpart
// (tests/cuda_emulator/cuda_runtime.h).
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
using TmaMap = CUtensorMap;
#else
using TmaMap = te_emu_tma_map;
#endif

// A tensor map for 2D TMA loads of a row-major array of dim1 rows of dim0
// elements (esize 4: float32, 2: bf16) at a pitch of pitch bytes, in boxes
// of box0 × box1 elements (box0 · esize = 128 bytes: one swizzle row) with
// the 128-byte swizzle; elements outside the array load as zeros. Returns
// a CUDA error code (cuTensorMapEncodeTiled is looked up through the
// runtime's entry-point query, so nothing links against libcuda).
inline int tma_map_2d(TmaMap* m, const void* base, int esize, uint64_t dim0,
                      uint64_t dim1, uint64_t pitch, uint32_t box0,
                      uint32_t box1) {
#ifdef __CUDACC__
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      m, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
#else
  return te_emu_tma_encode(m, base, esize, dim0, dim1, pitch, box0, box1);
#endif
}

// mbarrier.init with `count` expected arrivals a phase (one thread), then
// mbar_fence_init() and a block barrier before any use
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#ifdef __CUDACC__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
#else
  te_emu_mbar_init(bar, count);
#endif
}

__device__ __forceinline__ void mbar_fence_init() {
#ifdef __CUDACC__
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

// one arrival (release: this thread's shared-memory reads and writes before
// it are ordered before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
#else
  te_emu_mbar_arrive(bar, 0);
#endif
}

// one arrival that also expects `bytes` of asynchronous copies to complete
// on the barrier before its phase does
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
#ifdef __CUDACC__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
#else
  te_emu_mbar_arrive(bar, bytes);
#endif
}

// waits until the barrier's phase of parity `parity` has completed
// (acquire: what was written before it completed is visible after)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef __CUDACC__
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
#else
  te_emu_mbar_wait(bar, parity);
#endif
}

// TMA: the box of the map at element (c0, c1) into shared memory at dst
// (1024-byte aligned for the swizzle), its bytes completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const TmaMap* map,
                                            int c0, int c1, uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
#else
  te_emu_tma_load_2d(dst, map, c0, c1, bar);
#endif
}

// TMA, one dimension: `bytes` (a multiple of 16) from src into shared
// memory at dst (both 16-byte aligned), completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
#ifdef __CUDACC__
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
#else
  te_emu_bulk_load(dst, src, bytes, bar);
#endif
}

// A warpgroup's register budget: all four warps call it together, the
// producer to give registers back, the consumers to take them
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
#ifdef __CUDACC__
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
#ifdef __CUDACC__
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

// rows × cols values from device memory (row pitch ld) into shared memory
// (row pitch lds), by the whole block: with cp.async in 16-byte pieces
// when vec (both pitches, cols and the addresses allow it), else by plain
// copies. The caller commits, waits and synchronises.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* src,
                                          size_t ld, int rows, int cols,
                                          bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    const int pieces = cols / per;
    for (int idx = threadIdx.x; idx < rows * pieces; idx += blockDim.x) {
      const int r = idx / pieces, c = (idx - r * pieces) * per;
      cp_async16(dst + (size_t)r * lds + c, src + (size_t)r * ld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols, c = idx - r * cols;
      dst[(size_t)r * lds + c] = src[(size_t)r * ld + c];
    }
  }
}

// load_tile for float32 with every copy asynchronous: 4-byte cp.async where
// the rows do not allow 16-byte pieces
__device__ __forceinline__ void load_tile_async(float* dst, int lds,
                                                const float* src, size_t ld,
                                                int rows, int cols,
                                                bool vec) {
  if (vec) {
    load_tile(dst, lds, src, ld, rows, cols, true);
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols, c = idx - r * cols;
      cp_async4(dst + (size_t)r * lds + c, src + (size_t)r * ld + c);
    }
  }
}

// whether load_tile may take 16-byte pieces: rows of cols values at pitch
// ld from an address p
template <typename T>
__host__ __device__ inline bool tile_vec_ok(const T* p, size_t ld, int cols) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) &&
         (ld * sizeof(T)) % 16 == 0 && (cols * sizeof(T)) % 16 == 0;
}

// four consecutive values from shared memory, 16-byte aligned for float
// (one vector load); a double reads them one by one
template <typename T>
__device__ __forceinline__ void lds4(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == sizeof(float)) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = p[0]; v[1] = p[1]; v[2] = p[2]; v[3] = p[3];
  }
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
