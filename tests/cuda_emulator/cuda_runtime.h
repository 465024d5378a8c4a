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
// finished CUDA thread no longer takes part in __syncthreads. The bf16
// tensor-core product (mma.sync m16n8k16) is a warp-collective exchange of
// the lanes' fragment registers through per-warp slots; the warpgroup
// product (wgmma m64nNk16) is the same exchange across the 128 threads of a
// warpgroup, with B read from the emulated shared memory by decoding the
// matrix descriptor (128-byte swizzle) by the PTX ISA's rules; it completes
// at once, so its
// fence, commit and wait do nothing. The bf16 conversions are plain
// round-to-nearest-even bit arithmetic. The Hopper pipeline pieces of the
// GEMM core: an mbarrier is a record beside the emulated shared memory
// (expected and pending arrivals, a transaction count, the phase bit) under
// one lock, and a wait blocks on a condition variable until the phase with
// the given parity has completed; a TMA load copies its box at once (zeros
// outside the tensor, the 128-byte swizzle applied to the shared-memory
// offsets) and then completes its bytes on the barrier (the one-dimensional
// bulk copy likewise, without the swizzle); setmaxnreg does nothing.
#pragma once
#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <thread>
#include <unordered_map>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned int x, y, z, w; };
struct alignas(8) uint2 { unsigned int x, y; };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMultiProcessorCount = 16,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define __grid_constant__

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
constexpr std::size_t kSmemLimit = 232448;   // sm_90 opt-in maximum
constexpr std::size_t kSmemBuffer = 1 << 20;

struct BlockCtx {
  std::barrier<>* block_bar;
  std::vector<std::unique_ptr<std::barrier<>>>* warp_bars;
  std::vector<double>* slots;
  std::vector<uint32_t>* frags;   // 6 fragment registers per lane
  std::vector<std::unique_ptr<std::barrier<>>>* wg_bars;   // per warpgroup
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

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }

inline float te_emu_bf2f(uint16_t u) {
  const uint32_t bits = static_cast<uint32_t>(u) << 16;
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}
inline uint16_t te_emu_f2bf(float x) {     // round to nearest even (no NaNs)
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for one warp: every
// lane publishes its A (4 registers) and B (2 registers) fragments, then
// computes its own four accumulators from the whole tile.
inline void te_emu_mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                  const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  uint32_t* s = emu::ctx.frags->data() + static_cast<std::size_t>(w) * 32 * 6;
  for (int i = 0; i < 4; ++i) s[l * 6 + i] = a[i];
  s[l * 6 + 4] = b[0];
  s[l * 6 + 5] = b[1];
  __syncwarp();
  auto half = [](uint32_t reg, int k) {
    return te_emu_bf2f(static_cast<uint16_t>(reg >> (16 * (k & 1))));
  };
  const int g = l >> 2, t4 = l & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t4 + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 16; ++k) {
      const int ka = (k & 7) >> 1;
      const float av = half(s[((row & 7) * 4 + ka) * 6 + (row >> 3) + 2 * (k >> 3)], k);
      const float bv = half(s[(col * 4 + ka) * 6 + 4 + (k >> 3)], k);
      acc += av * bv;
    }
    d[i] = acc;
  }
  __syncwarp();
}

extern unsigned char te_smem[];

// the shared-window address of a pointer into the emulated shared memory
inline uint32_t te_emu_smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - te_smem);
}

// wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16 with A from registers,
// for one warpgroup: every thread publishes its four A registers, then
// computes its own N/2 accumulators from the whole 64 × 16 A and the 16 × N
// B that the descriptor addresses. The descriptor is decoded by the PTX
// ISA's rules for the 128-byte swizzle (layout type 1, base offset 0; any
// other layout throws): B's element (n, k) lies, K-major (tb = 0), at
// start + (n/8)·SBO + (n%8)·128 + (k/8)·16 + (k%8)·2, MN-major (tb = 1) at
// start + (n/64)·LBO + (n%64)·2 + (k/8)·SBO + (k%8)·128, and the swizzle
// XORs address bits 4-6 with bits 7-9. Sums run over k in ascending order.
template <int N>
inline void te_emu_wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t desc, int tb) {
  if ((desc >> 62) != 1 || ((desc >> 49) & 7u) != 0)
    throw std::runtime_error("wgmma descriptor: not a 128-byte swizzle");
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFFu) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFFu) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFFu) << 4;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  std::barrier<>& bar = *(*emu::ctx.wg_bars)[wg];
  uint32_t* s = emu::ctx.frags->data() + static_cast<std::size_t>(wg) * 128 * 6;
  for (int i = 0; i < 4; ++i) s[t * 6 + i] = a[i];
  bar.arrive_and_wait();
  auto half = [](uint32_t reg, int k) {
    return te_emu_bf2f(static_cast<uint16_t>(reg >> (16 * (k & 1))));
  };
  auto A = [&](int row, int k) {        // row in [0, 64), k in [0, 16)
    const int owner = (row / 16) * 32 + (row % 8) * 4 + (k % 8) / 2;
    const int reg = (row % 16) / 8 + 2 * (k / 8);
    return half(s[owner * 6 + reg], k);
  };
  auto B = [&](int n, int k) {
    uint32_t off =
        tb ? start + (n / 64) * lbo + (n % 64) * 2 + (k / 8) * sbo + (k % 8) * 128
           : start + (n / 8) * sbo + (n % 8) * 128 + (k / 8) * 16 + (k % 8) * 2;
    off ^= ((off >> 7) & 7u) << 4;
    uint16_t u;
    std::memcpy(&u, te_smem + off, sizeof u);
    return te_emu_bf2f(u);
  };
  const int w = t / 32, g = (t % 32) / 4, q = t % 4;
  for (int idx = 0; idx < N / 2; ++idx) {
    const int j = idx / 4, i = idx % 4;
    const int row = 16 * w + g + 8 * (i / 2), col = 8 * j + 2 * q + i % 2;
    float acc = d[idx];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(col, k);
    d[idx] = acc;
  }
  bar.arrive_and_wait();
}

// mbarrier (shared::cta): init, arrive (with an optional expect-tx of
// `tx` bytes), complete-tx, and the parity wait
namespace emu {
struct Mbar {
  int expected = 0, pending = 0;
  long tx = 0;
  unsigned phase = 0;
};
inline std::mutex mbar_mu;
inline std::condition_variable mbar_cv;
inline std::unordered_map<const void*, Mbar> mbars;
inline void mbar_settle(Mbar& b) {     // under mbar_mu
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.pending = b.expected;
    mbar_cv.notify_all();
  }
}
}  // namespace emu

inline void te_emu_mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> lk(emu::mbar_mu);
  emu::mbars[bar] = emu::Mbar{count, count, 0, 0};
}
inline void te_emu_mbar_arrive(void* bar, long tx) {
  std::lock_guard<std::mutex> lk(emu::mbar_mu);
  emu::Mbar& b = emu::mbars.at(bar);
  b.tx += tx;
  if (--b.pending < 0) throw std::runtime_error("mbarrier: too many arrivals");
  emu::mbar_settle(b);
}
inline void te_emu_mbar_complete_tx(void* bar, long bytes) {
  std::lock_guard<std::mutex> lk(emu::mbar_mu);
  emu::Mbar& b = emu::mbars.at(bar);
  b.tx -= bytes;
  emu::mbar_settle(b);
}
// returns once the phase of parity `parity` has completed (the barrier's
// current phase bit differs from it)
inline void te_emu_mbar_wait(void* bar, unsigned parity) {
  std::unique_lock<std::mutex> lk(emu::mbar_mu);
  emu::mbar_cv.wait(lk, [&] { return emu::mbars.at(bar).phase != parity; });
}

// A 2D tensor map for the TMA load: a row-major array of dim1 rows of dim0
// elements of esize bytes at a pitch of stride1 bytes, boxes of box0 × box1
// elements, 128-byte swizzle (box0 · esize ≤ 128).
struct te_emu_tma_map {
  const unsigned char* base;
  int esize;
  uint64_t dim0, dim1, stride1;
  uint32_t box0, box1;
};

inline int te_emu_tma_encode(te_emu_tma_map* m, const void* base, int esize,
                             uint64_t dim0, uint64_t dim1, uint64_t stride1,
                             uint32_t box0, uint32_t box1) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || stride1 % 16 ||
      stride1 < dim0 * esize || box0 * esize > 128 || box0 * esize % 16 ||
      box1 == 0 || box1 > 256)
    return 1;
  *m = te_emu_tma_map{static_cast<const unsigned char*>(base), esize, dim0,
                      dim1, stride1, box0, box1};
  return 0;
}

extern unsigned char te_smem[];

// the box at element (c0, c1) into shared memory at dst (1024-byte aligned):
// row r of the box is the 128-byte row r, its 16-byte chunks placed by the
// 128-byte swizzle (chunk ^= row mod 8); elements outside the tensor read as
// zeros; then the box's bytes complete on the barrier
inline void te_emu_tma_load_2d(void* dst, const te_emu_tma_map* m, int c0,
                               int c1, void* bar) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  if ((d - te_smem) % 1024) throw std::runtime_error("TMA: unaligned box");
  const uint32_t row = m->box0 * m->esize;
  for (uint32_t r = 0; r < m->box1; ++r)
    for (uint32_t i = 0; i < m->box0; ++i) {
      const uint32_t off = r * row + i * m->esize;
      unsigned char* to = d + (off ^ (((off >> 7) & 7u) << 4));
      const long x = static_cast<long>(c0) + i, y = static_cast<long>(c1) + r;
      if (x >= 0 && y >= 0 && static_cast<uint64_t>(x) < m->dim0 &&
          static_cast<uint64_t>(y) < m->dim1)
        std::memcpy(to, m->base + y * m->stride1 + x * m->esize, m->esize);
      else
        std::memset(to, 0, m->esize);
    }
  te_emu_mbar_complete_tx(bar, static_cast<long>(row) * m->box1);
}

// the one-dimensional TMA copy: `bytes` at once, then they complete on the
// barrier; both addresses and the size must be multiples of 16
inline void te_emu_bulk_load(void* dst, const void* src, uint32_t bytes,
                             void* bar) {
  if (reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16 ||
      (static_cast<unsigned char*>(dst) - te_smem) % 16)
    throw std::runtime_error("bulk copy: unaligned");
  std::memcpy(dst, src, bytes);
  te_emu_mbar_complete_tx(bar, static_cast<long>(bytes));
}

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? 132
                                               : static_cast<int>(emu::kSmemLimit);
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
          const unsigned ngroups = (nthreads + 127) / 128;
          std::vector<std::unique_ptr<std::barrier<>>> wg_bars;
          for (unsigned w = 0; w < ngroups; ++w)
            wg_bars.emplace_back(
                new std::barrier<>(std::min(128u, nthreads - 128 * w)));
          std::vector<double> slots(nwarps * 32);
          std::vector<uint32_t> frags(std::max(nwarps * 32, ngroups * 128) * 6);
          std::vector<std::thread> threads;
          for (unsigned t = 0; t < nthreads; ++t) {
            threads.emplace_back([&, t]() {
              threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                               t / (block.x * block.y));
              blockIdx = dim3(bx, by, bz);
              blockDim = block;
              gridDim = grid;
              ctx = BlockCtx{&bar, &warp_bars, &slots, &frags, &wg_bars};
              kernel(args...);
              wg_bars[t / 128]->arrive_and_drop();
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
