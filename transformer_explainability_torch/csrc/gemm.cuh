// The one hand-written GEMM core of the layer kernels (block_fwd.cu,
// block_rev.cu, mlp_rev.cu, mlp_rev_tp.cu, bert_fwd.cu, bert_out_rev.cu,
// bert_attn_rev.cu): C = A·B with float32 activations A and bf16 weight
// planes B, on the Hopper tensor cores (wgmma), with a fused elementwise
// epilogue.
//
// It computes what _kdot of transformer_explainability_tpu/ops/
// pallas_kernels.py computes for an activation times a prepared weight:
//   kBf16:   bf16(A)·hi                          (one pass)
//   kBf16x3: hi(A)·hi + (hi(A)·lo + lo(A)·hi)    (three passes into two
//            accumulator sets, set 0 + set 1 in the epilogue: associated as
//            JAX associates)
// where A = hi(A) + lo(A) is split with round-to-nearest-even and the
// weight W = hi + lo arrives split once per model (ops/precision.py).
//
// Shapes: A (M, K) row-major float32 with row pitch lda. W is an nn.Linear
// weight (out, in) row-major with pitch ldw; B = Wᵀ (WT = true: k is W's
// column, the forward products x·Wᵀ) or B = W (WT = false: k is W's row,
// the backward and rule products g·W). ABS takes |A|; its caller passes
// |W|'s planes (|hi|, sign(hi)·lo) (JAX _kabs, made once per model beside
// the split: precision.PreparedWeight.abs) as Whi, Wlo. DUAL returns A·W
// and A·|W| (planes Wahi, Walo) from one A operand (each α-β rule needs
// both). For every element of C inside (M, N) the epilogue's load(row,
// col) reads its inputs, then it gets (row, col, A·B, A·|B|, inputs).
//
// What bounds it on the H100: the bf16 tensor-core rate (989 TFLOP/s) at
// the main paths' shapes (2·M·N·K per pass, K = 768 or 3072, M·N ≥ 1.2M):
// every product is operations-bound. Only wgmma reaches that rate, and only
// if the tensor cores are fed without gaps: so
//   - a block is WG consumer warpgroups of 64 rows each (BM = 64·WG) over
//     BN columns; each warpgroup issues wgmma m64nBNk16, A from registers,
//     B from shared memory through a descriptor;
//   - a ring of 3 shared-memory stages of (A float32 BM × 64, B planes BN ×
//     64 bf16) is filled by cp.async (16-byte copies, zero-filled past M, N
//     and K) two stages ahead, one barrier per stage; every quarter-warp
//     copies 128 contiguous bytes of one row (B's 64-byte row pieces of
//     32-deep stages made the copies, not the tensor cores, the bound);
//   - each warp splits its 16 rows of the staged float32 A into bf16 (hi,
//     lo) fragments in registers (|A| for ABS), one 16-deep k-slice at a
//     time, and never writes them back; each slice's wgmma are one commit
//     group, so the next slice's split overlaps them; the step waits for
//     all its groups (wait_group 0) before the next barrier. Keeping a
//     group in flight across the barrier (wait_group 1 with fragments
//     double-buffered by step) made ptxas serialise every wgmma (C7513);
//   - B lies in the stage as 128-byte swizzled rows (K-major with WT,
//     MN-major, wgmma's transposed B, without), so the copies' 16-byte
//     chunks land conflict-free, wgmma reads them conflict-free, and W is
//     never transposed element by element;
//   - the accumulators take NS·BN/2 registers a thread for NS sets (2 with
//     bf16×3, 2 with DUAL, 4 with both), so BN shrinks with NS (192, 128,
//     64 at WG = 2); the tile (WG, BN) is a pure function of (M, N, mode,
//     DUAL) (gemm_small_tile), so a forward and its recompute run the same
//     instance and give bitwise the same products;
//   - the epilogue stages the tile's sums in shared memory, so that each
//     warp calls it on 32 consecutive columns of one row (whole 128-byte
//     lines of every C-shaped array it reads or writes), and calls it in
//     two steps, the loads of eight elements before their stores (else
//     each element's loads wait for the previous element's stores).
// Every sum has a fixed order (no atomics, no split-K): bitwise repeatable.
// K and N must be multiples of 8, lda of 4, ldw of 8, A and the planes
// 16-byte aligned.
#pragma once

#include "common.cuh"

namespace te {

enum GemmMode { kBf16 = 0, kBf16x3 = 1 };

constexpr int kGemmBK = 64;                  // k per stage
constexpr int kGemmApitch = kGemmBK + 8;     // floats per staged A row
constexpr int kGemmSMs = 132;                // H100 SXM: for the tile choice

struct GemmArgs {
  const float* A;
  const uint16_t* Whi;
  const uint16_t* Wlo;   // may be null in kBf16 mode
  int lda, ldw, M, N, K;
  const uint16_t* Wahi = nullptr;   // DUAL: the planes of |W|
  const uint16_t* Walo = nullptr;
};

// The byte offset of the 16-byte chunk `chunk` (0..7) of 128-byte row
// `row` of a B plane under the 128-byte swizzle (wgmma layout type 1): the
// chunk's position in its row is XORed with the row's index mod 8, so that
// the 8 rows of an 8 × 128-byte atom (1024-byte aligned) spread any one
// chunk position over all banks.
__host__ __device__ inline int swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// One tile configuration: WG consumer warpgroups (BM = 64·WG rows) × BN
// columns, NS accumulator sets and as many B planes per stage (hi, lo for
// bf16×3, then |W|'s for DUAL).
template <int MODE, bool WT, bool ABS, bool DUAL, int WG, int BN>
struct GemmTile {
  static constexpr bool X3 = MODE == kBf16x3;
  static constexpr int NS = (X3 ? 2 : 1) * (DUAL ? 2 : 1);
  static constexpr int NA = X3 ? 2 : 1;          // A fragment planes
  static constexpr int KS = kGemmBK / 16;        // k-slices (wgmma) a stage
  static constexpr int BM = 64 * WG, THREADS = 128 * WG;
  static constexpr int STAGES = 3, AHEAD = STAGES - 1;
  static constexpr int A_BYTES = BM * kGemmApitch * 4;
  static constexpr int P_BYTES = BN * kGemmBK * 2;
  static constexpr int STAGE = A_BYTES + NS * P_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 1024;   // + base alignment
  // B planes, 128-byte swizzle, in 1024-byte atoms of 8 rows × 128 bytes:
  // K-major (WT): row n holds k 0..63 of W's row n; atoms stack along n
  // (SBO 1024; LBO unused); k-slice s starts 32·s bytes into the row.
  // MN-major: row k holds 64 n; atom (k/8, n/64) at (n/64 · 8 + k/8) ·
  // 1024, so SBO (next 8 k) 1024 and LBO (next 64 n) 8192; k-slice s
  // starts at atom row 2s.
  static constexpr uint32_t LBO = WT ? 16 : 8 * 1024;
  static constexpr uint32_t SBO = 1024;
  static constexpr uint32_t SLICE = WT ? 32 : 2 * 1024;
  static_assert(BN % 64 == 0 && BN <= 192 && BN * 8 % THREADS == 0,
                "tile width");
  static_assert(A_BYTES % 1024 == 0 && P_BYTES % 1024 == 0, "alignment");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(BM * (BN + 8) * 4 * (DUAL ? 2 : 1) <= STAGES * STAGE,
                "epilogue staging");

  using Acc = float[NS][BN / 2];
  using Frag = uint32_t[NA][KS][4];   // [plane][k-slice][reg]

  // one stage's copies, a quarter-warp on 128 contiguous bytes of one row
  // in device memory and on the 8 chunks of one 128-byte row in shared
  // memory: A rows m0.. (BM × 16 pieces of 4 floats), each B plane (BN ×
  // 8 pieces of 8 bf16)
  static __device__ __forceinline__ void load(const GemmArgs& g,
                                              const uint16_t* const (&pl)[NS],
                                              unsigned char* st, int m0,
                                              int n0, int k0, int t) {
    float* As = reinterpret_cast<float*>(st);
#pragma unroll
    for (int i = 0; i < BM * 16 / THREADS; ++i) {
      const int c = t + i * THREADS, r = c >> 4, q = c & 15;
      const int row = m0 + r, k = k0 + 4 * q;
      const bool ok = row < g.M && k < g.K;
      cp_async16_zfill(As + r * kGemmApitch + 4 * q,
                       ok ? g.A + (size_t)row * g.lda + k : g.A, ok);
    }
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      unsigned char* Bs = st + A_BYTES + p * P_BYTES;
#pragma unroll
      for (int i = 0; i < BN * 8 / THREADS; ++i) {
        const int c = t + i * THREADS;
        int n, k, off;
        size_t o;
        if constexpr (WT) {
          const int nl = c >> 3, j = c & 7;
          n = n0 + nl;
          k = k0 + 8 * j;
          off = swz128(nl, j);
          o = (size_t)n * g.ldw + k;
        } else {
          const int kl = c / (BN / 8), nc = c % (BN / 8);
          k = k0 + kl;
          n = n0 + 8 * nc;
          off = (nc >> 3) * 8192 + (kl >> 3) * 1024 + swz128(kl & 7, nc & 7);
          o = (size_t)k * g.ldw + n;
        }
        const bool ok = n < g.N && k < g.K;
        cp_async16_zfill(Bs + off, ok ? pl[p] + o : pl[p], ok);
      }
    }
  }

  // k-step kt: wait for its stage, start the copies AHEAD steps on (into
  // the stage step kt − 1 read: its wgmma have completed), then for each
  // k-slice split this warp's A rows into its fragments and issue its
  // wgmma group (the next slice's split overlaps this group); wait for all
  static __device__ __forceinline__ void step(const GemmArgs& g,
                                              const uint16_t* const (&pl)[NS],
                                              unsigned char* sm, int m0,
                                              int n0, int kt, int nk, int t,
                                              Acc& acc, Frag& fr) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (kt + AHEAD < nk)
      load(g, pl, sm + ((kt + AHEAD) % STAGES) * STAGE, m0, n0,
           (kt + AHEAD) * kGemmBK, t);
    cp_async_commit();

    unsigned char* st = sm + (kt % STAGES) * STAGE;
    const float* As = reinterpret_cast<const float*>(st);
    const int lane = t & 31, gi = lane >> 2, q = lane & 3;
    const int r0 = (t >> 7) * 64 + ((t >> 5) & 3) * 16 + gi;
    const uint32_t sb = smem_u32(st + A_BYTES);
    constexpr int TB = WT ? 0 : 1;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 v = *reinterpret_cast<const float2*>(
              As + (r0 + 8 * rr) * kGemmApitch + 16 * s + 8 * h + 2 * q);
          const float x0 = ABS ? fabsf(v.x) : v.x;
          const float x1 = ABS ? fabsf(v.y) : v.y;
          const uint32_t hp = pack_bf16x2(x0, x1);
          fr[0][s][rr + 2 * h] = hp;
          if constexpr (X3)
            fr[1][s][rr + 2 * h] =
                pack_bf16x2(x0 - bf2f((uint16_t)hp), x1 - bf2f(hp >> 16));
        }
      wgmma_fence();
      uint64_t d[NS];
#pragma unroll
      for (int p = 0; p < NS; ++p)
        d[p] = wgmma_desc128(sb + p * P_BYTES + s * SLICE, LBO, SBO);
      // set 0: hi·hi; set 1 (x3): hi·lo + lo·hi; DUAL: the same on |W|
      wgmma_bf16<BN, TB>(acc[0], fr[0][s], d[0]);
      if constexpr (X3) {
        wgmma_bf16<BN, TB>(acc[1], fr[0][s], d[1]);
        wgmma_bf16<BN, TB>(acc[1], fr[1][s], d[0]);
      }
      if constexpr (DUAL) {
        constexpr int a = X3 ? 2 : 1;
        wgmma_bf16<BN, TB>(acc[a], fr[0][s], d[a]);
        if constexpr (X3) {
          wgmma_bf16<BN, TB>(acc[a + 1], fr[0][s], d[a + 1]);
          wgmma_bf16<BN, TB>(acc[a + 1], fr[1][s], d[a]);
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
  }
};

template <int MODE, bool WT, bool ABS, bool DUAL, int WG, int BN, class Epi>
__global__ void __launch_bounds__(128 * WG, 1)
gemm_kernel(GemmArgs g, Epi epi) {
  using T = GemmTile<MODE, WT, ABS, DUAL, WG, BN>;
  constexpr int NS = T::NS;
  // the stages from the first 1024-byte boundary (the swizzle atoms')
  unsigned char* const sm = te_smem + ((1024 - (smem_u32(te_smem) & 1023)) & 1023);
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int nk = (g.K + kGemmBK - 1) / kGemmBK;
  const uint16_t* pl[NS];
  pl[0] = g.Whi;
  if constexpr (T::X3) pl[1] = g.Wlo;
  if constexpr (DUAL) {
    pl[T::X3 ? 2 : 1] = g.Wahi;
    if constexpr (T::X3) pl[3] = g.Walo;
  }

  typename T::Acc acc;
  typename T::Frag fr;
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.f;

#pragma unroll
  for (int s = 0; s < T::AHEAD; ++s) {
    if (s < nk) T::load(g, pl, sm + s * T::STAGE, m0, n0, s * kGemmBK, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt)
    T::step(g, pl, sm, m0, n0, kt, nk, t, acc, fr);
  cp_async_wait<0>();

  // The tile's products (set 0 + set 1; and A·|W|) through shared memory
  // (the stages are free), so that each warp runs the epilogue on 32
  // consecutive columns of one row: its reads and writes of C-shaped
  // arrays are whole 128-byte lines.
  constexpr int EP = BN + 8;           // staged row pitch: no bank conflicts
  float* const Vs = reinterpret_cast<float*>(sm);
  float* const Ws = Vs + T::BM * EP;   // DUAL
  __syncthreads();
  const int lane = t & 31, gi = lane >> 2, q = lane & 3;
  const int r0 = (t >> 7) * 64 + ((t >> 5) & 3) * 16 + gi;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int e = 4 * j + 2 * hr, o = (r0 + 8 * hr) * EP + 8 * j + 2 * q;
      float2 v = {acc[0][e], acc[0][e + 1]};
      if constexpr (T::X3) {
        v.x += acc[1][e];
        v.y += acc[1][e + 1];
      }
      *reinterpret_cast<float2*>(Vs + o) = v;
      if constexpr (DUAL) {
        constexpr int a = T::X3 ? 2 : 1;
        float2 w = {acc[a][e], acc[a][e + 1]};
        if constexpr (T::X3) {
          w.x += acc[3][e];
          w.y += acc[3][e + 1];
        }
        *reinterpret_cast<float2*>(Ws + o) = w;
      }
    }
  }
  __syncthreads();
  // U elements at a time: all their loads, then all their stores (a
  // thread's load after its own store need not wait, but the compiler may
  // not move it above a store that could alias it)
  constexpr int U = 8;
  static_assert(T::BM * BN % (U * T::THREADS) == 0, "epilogue batches");
  for (int e0 = t; e0 < T::BM * BN; e0 += U * T::THREADS) {
    typename Epi::In in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * T::THREADS, r = e / BN, c = e - r * BN;
      if (m0 + r < g.M && n0 + c < g.N) in[u] = epi.load(m0 + r, n0 + c);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * T::THREADS, r = e / BN, c = e - r * BN;
      if (m0 + r < g.M && n0 + c < g.N)
        epi(m0 + r, n0 + c, Vs[r * EP + c], DUAL ? Ws[r * EP + c] : 0.f,
            in[u]);
    }
  }
}

// The tile for an (M, N) product with ns accumulator sets: the large one
// (2 warpgroups, 128 × 192 / 128 / 64 for 1 / 2 / 4 sets, one block an SM)
// or the small one (1 warpgroup, 64 × 128 / 128 / 64), whichever takes
// less time: SM-waves times the work of one wave, the small tile's
// weighted by its measured cost per element. A pure function of the shape
// and the sets, so every caller of a shape runs the same tile.
inline bool gemm_small_tile(int M, int N, int ns) {
  const int bn_big = ns == 1 ? 192 : ns == 2 ? 128 : 64;
  const int bn_small = ns == 4 ? 64 : 128;
  // the small tile's blocks an SM (its shared memory: two with one set,
  // else one) and its time per output element relative to the large
  // tile's (on an H100 at the main paths' shapes, where both fill the
  // card: experiments/torch_gemm_tiles.py)
  const int per_sm = ns == 1 ? 2 : 1;
  const double slower = ns == 1 ? 1.15 : 1.3;
  auto waves = [&](int bm, int bn, int slots) {
    const long tiles = (long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    return (tiles + slots - 1) / slots;
  };
  const double big = (double)waves(128, bn_big, kGemmSMs) * 128 * bn_big;
  const double small = (double)waves(64, bn_small, kGemmSMs * per_sm) * 64 *
                       bn_small * per_sm * slower;
  return small < big;
}

template <int MODE, bool WT, bool ABS, bool DUAL, int WG, int BN, class Epi>
int gemm_launch(const GemmArgs& g, const Epi& epi, cudaStream_t stream) {
  using T = GemmTile<MODE, WT, ABS, DUAL, WG, BN>;
  auto kern = gemm_kernel<MODE, WT, ABS, DUAL, WG, BN, Epi>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + BN - 1) / BN, (g.M + T::BM - 1) / T::BM);
  TE_LAUNCH(kern, grid, T::THREADS, T::SMEM, stream)(g, epi);
  return (int)cudaGetLastError();
}

template <int MODE, bool WT, bool ABS, bool DUAL, class Epi>
int gemm_tiled(const GemmArgs& g, const Epi& epi, cudaStream_t stream,
               int tile) {
  constexpr int NS = (MODE == kBf16x3 ? 2 : 1) * (DUAL ? 2 : 1);
  constexpr int BIG = NS == 1 ? 192 : NS == 2 ? 128 : 64;
  constexpr int SMALL = NS == 4 ? 64 : 128;
  const bool small = tile < 0 ? gemm_small_tile(g.M, g.N, NS) : tile == 1;
  return small ? gemm_launch<MODE, WT, ABS, DUAL, 1, SMALL>(g, epi, stream)
               : gemm_launch<MODE, WT, ABS, DUAL, 2, BIG>(g, epi, stream);
}

// Launch in the mode the caller names; kBf16x3 needs the lo planes, DUAL
// the planes of |W|. tile: -1 the shape's tile (gemm_small_tile), 0 the
// large one, 1 the small one (the core's own checks cross both).
template <bool WT, bool ABS, bool DUAL, class Epi>
int gemm(int mode, const GemmArgs& g, const Epi& epi, cudaStream_t stream,
         int tile = -1) {
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return (int)cudaSuccess;
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (g.K % 8 || g.N % 8 || g.lda % 4 || g.ldw % 8 || misaligned(g.A) ||
      g.Whi == nullptr || misaligned(g.Whi) || misaligned(g.Wlo) ||
      misaligned(g.Wahi) || misaligned(g.Walo) ||
      (DUAL && g.Wahi == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == kBf16) return gemm_tiled<kBf16, WT, ABS, DUAL>(g, epi, stream, tile);
  if (mode == kBf16x3 && g.Wlo != nullptr && (!DUAL || g.Walo != nullptr))
    return gemm_tiled<kBf16x3, WT, ABS, DUAL>(g, epi, stream, tile);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Row kernels and elementwise pieces shared by the forward and the reverse
// kernel. The forward and the reverse call the same compiled functions on
// the same values, so every anchor a rule divides by is bitwise the value
// its numerator was linearised at.
// ---------------------------------------------------------------------------

constexpr float kSqrt2 = 1.41421356237309504880f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

// JAX _gelu_exact with erff
__device__ __forceinline__ float gelu(float x) {
  return mul_rn(x, mul_rn(0.5f, add_rn(1.0f, erff(x / kSqrt2))));
}

// JAX _gelu_grad: Φ(x) + x·φ(x)
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x / kSqrt2));
  const float pdf = expf(-0.5f * x * x) * kInvSqrt2Pi;
  return cdf + x * pdf;
}

// mean and 1/sqrt(var + eps) of one row, one warp per row (lane-strided
// sums, butterfly reduction: a fixed order)
__device__ __forceinline__ void ln_stats(const float* x, int D, float eps,
                                         int lane, float& mu, float& inv) {
  float s = 0.f;
  for (int c = lane; c < D; c += kWarp) s += x[c];
  mu = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int c = lane; c < D; c += kWarp) {
    const float d = x[c] - mu;
    v += d * d;
  }
  inv = 1.0f / sqrtf(warp_sum(v) / (float)D + eps);
}

constexpr int kRowWarps = 8;

// xn = (x − μ)·inv·s + b (JAX _ln_fwd), rows of width D
static __global__ void __launch_bounds__(kRowWarps * kWarp)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ b, float* __restrict__ xn, int rows,
              int D, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * D;
  float mu, inv;
  ln_stats(xr, D, eps, lane, mu, inv);
  for (int c = lane; c < D; c += kWarp)
    xn[(size_t)row * D + c] =
        add_rn(mul_rn(mul_rn(xr[c] - mu, inv), s[c]), b[c]);
}

// out = g_res + LayerNorm backward of g (JAX _block_rev_math's LN tails);
// a null g_res adds nothing
static __global__ void __launch_bounds__(kRowWarps * kWarp)
ln_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ s, const float* __restrict__ g_res,
              float* __restrict__ out, int rows, int D, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  float mu, inv;
  ln_stats(x + o, D, eps, lane, mu, inv);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += kWarp) {
    const float gg = g[o + c] * s[c];
    s1 += gg;
    s2 += gg * ((x[o + c] - mu) * inv);
  }
  const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
  for (int c = lane; c < D; c += kWarp) {
    const float gg = g[o + c] * s[c];
    const float xhat = (x[o + c] - mu) * inv;
    const float r = g_res ? g_res[o + c] : 0.f;
    out[o + c] = r + inv * (gg - m1 - xhat * m2);
  }
}

inline int ln_fwd(const float* x, const float* s, const float* b, float* xn,
                  int rows, int D, float eps, cudaStream_t stream) {
  TE_LAUNCH(ln_fwd_kernel, (rows + kRowWarps - 1) / kRowWarps,
            kRowWarps * kWarp, 0, stream)(x, s, b, xn, rows, D, eps);
  return (int)cudaGetLastError();
}

inline int ln_bwd(const float* g, const float* x, const float* s,
                  const float* g_res, float* out, int rows, int D, float eps,
                  cudaStream_t stream) {
  TE_LAUNCH(ln_bwd_kernel, (rows + kRowWarps - 1) / kRowWarps,
            kRowWarps * kWarp, 0, stream)(g, x, s, g_res, out, rows, D, eps);
  return (int)cudaGetLastError();
}

// The forward GEMM epilogues (block_fwd.cu, bert_fwd.cu; the reverse
// kernels repeat the forward with them, bitwise). Every epilogue is two
// calls per element: load(r, c) reads what it needs of its own arrays (an
// In), and operator()(r, c, A·B, A·|B|, in) computes and stores, so that
// the GEMM issues the loads of several elements before any store.
// qkv GEMM: qkv_pre, and qkv = qkv_pre + bqkv for the attention core
struct EpiQkv {
  float* pre; float* biased; const float* bias; int N;
  struct In { float bias; };
  __device__ In load(int, int c) const { return {bias[c]}; }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    const size_t o = (size_t)r * N + c;
    pre[o] = a;
    biased[o] = a + in.bias;
  }
};

// proj / fc2 GEMMs: the pre-bias product, and out = res + (pre + bias)
struct EpiResidual {
  float* pre; float* out; const float* res; const float* bias; int N;
  struct In { float res, bias; };
  __device__ In load(int r, int c) const {
    return {res[(size_t)r * N + c], bias[c]};
  }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    const size_t o = (size_t)r * N + c;
    pre[o] = a;
    out[o] = in.res + (a + in.bias);
  }
};

// fc1 GEMM: fc1_pre, and hg = gelu(fc1_pre + b1) for the fc2 GEMM
struct EpiGelu {
  float* pre; float* hg; const float* bias; int N;
  struct In { float bias; };
  __device__ In load(int, int c) const { return {bias[c]}; }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    const size_t o = (size_t)r * N + c;
    pre[o] = a;
    hg[o] = gelu(a + in.bias);
  }
};

// One block's parameters: LayerNorm scales and biases and Linear biases in
// float32, the four weights as bf16 (hi, lo) planes in the nn.Linear layout
// (out, in); a lo plane is null where the weights are prepared for bf16.
struct BlockWeights {
  const float *ln1s, *ln1b, *ln2s, *ln2b, *bqkv, *bproj, *b1, *b2;
  const uint16_t *wqkv_hi, *wqkv_lo, *wproj_hi, *wproj_lo;
  const uint16_t *w1_hi, *w1_lo, *w2_hi, *w2_lo;
  // the planes of |W| (|hi|, sign(hi)·lo), which the rule products read;
  // null in the forward kernels
  const uint16_t *wqkv_ahi = nullptr, *wqkv_alo = nullptr;
  const uint16_t *wproj_ahi = nullptr, *wproj_alo = nullptr;
  const uint16_t *w1_ahi = nullptr, *w1_alo = nullptr;
  const uint16_t *w2_ahi = nullptr, *w2_alo = nullptr;
};

// Sets w's |W| planes from 8 pointers: (ahi, alo) of qkv, proj, fc1, fc2.
inline void set_abs_planes(BlockWeights& w, const void* const (&a)[8]) {
  using W = const uint16_t*;
  w.wqkv_ahi = static_cast<W>(a[0]);
  w.wqkv_alo = static_cast<W>(a[1]);
  w.wproj_ahi = static_cast<W>(a[2]);
  w.wproj_alo = static_cast<W>(a[3]);
  w.w1_ahi = static_cast<W>(a[4]);
  w.w1_alo = static_cast<W>(a[5]);
  w.w2_ahi = static_cast<W>(a[6]);
  w.w2_alo = static_cast<W>(a[7]);
}

// Bump allocator over one workspace (a null base only measures it).
struct Carve {
  char* base;
  size_t used = 0;
  template <typename T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * sizeof(T) + 255) & ~(size_t)255;
    return p;
  }
};

// return a non-zero error code at once (variadic: template commas)
#define TE_TRY(...)                       \
  do {                                    \
    const int te_err_ = (__VA_ARGS__);    \
    if (te_err_ != 0) return te_err_;     \
  } while (0)

}  // namespace te
