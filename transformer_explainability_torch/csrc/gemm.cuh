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
//   kBf16x3Rn: the same three passes into one set over each 64-deep k-step
//            (the cross terms first), which is then added to the second set
//            with round-to-nearest and cleared: the MLP products' mode
//            (gemm_mlp: the MLP products of B2, B3, B6 and, since fault
//            C8, of B7, B8 and B10a in bf16×3). wgmma's float32
//            accumulation truncates (−1.1e-5
//            relative at K = 3072 on one chain over k), and on the MLP
//            products, whose sums feed the α-β rules' divides, that made
//            B6's and B3's Rm err up to 30× the plain version's limit at
//            ViT-L widths (fault C5); cut at every k-step and summed on the
//            CUDA cores the chain errs as a float32 sum. It takes the two
//            sets kBf16x3 takes, so the tiles and registers do not change.
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
//     BN columns and one producer warpgroup; each consumer warpgroup issues
//     wgmma m64nBNk16, A from registers, B from shared memory through a
//     descriptor;
//   - the producer (one thread; its warpgroup gives its registers to the
//     consumers with setmaxnreg) keeps a ring of 2-4 stages of 64 k full
//     with TMA loads (the A rows and B planes of the stage in 128-byte
//     swizzled boxes, zeros past M, N and K), each stage with a "full"
//     mbarrier (its bytes arrived) and an "empty" one (every consumer warp
//     is done with it): no block-wide barrier in the k-loop, and the
//     producer runs on into the next tile while the consumers run this
//     one's epilogue;
//   - the grid is persistent (at most the blocks the card holds at once)
//     and walks the tiles of one product, or of two independent products
//     in one grouped launch (gemm_run), in a fixed order, so that small
//     products share the card's SMs instead of leaving a partial wave;
//   - each warp splits its 16 rows of a staged float32 A into bf16 (hi,
//     lo) fragments in registers (|A| for ABS), one 16-deep k-slice at a
//     time, and never writes them back (a bf16 A is loaded as its own
//     fragments); each slice's wgmma are one commit group, so the next
//     slice's split overlaps them; the step waits for all its groups
//     (wait_group 0) before it releases the stage. Keeping a group in
//     flight across steps (wait_group 1 with fragments double-buffered by
//     step) made ptxas serialise every wgmma (C7513);
//   - B lies in the stage as 128-byte swizzled rows (K-major with WT,
//     MN-major, wgmma's transposed B, without), so wgmma reads them
//     conflict-free and W is never transposed element by element; A's
//     boxes take the same swizzle, so a quarter-warp's fragment reads
//     spread over all banks;
//   - the accumulators take NS·BN/2 registers a thread for NS sets (2 with
//     bf16×3, 2 with DUAL, 4 with both), so BN shrinks with NS (192, 128,
//     64 at WG = 2); the tile (WG, BN) is a pure function of (M, N, mode,
//     DUAL) (gemm_small_tile), so a forward and its recompute run the same
//     instance and give bitwise the same products;
//   - the fused passes of the tensor-parallel MLP kernels (SpecTwoA,
//     SpecDualAbsA, SpecThree) put two or three products that share an
//     output tile or an A operand into one pass, each product's chain over
//     k the same as its own launch's;
//   - each consumer warp stages its sums in its own shared memory, 8 rows
//     × BN (a loop over 32-column pieces, the next piece's inputs loaded
//     while this one stores) or 8 × 32 at a time (GemmRing::HALF), so that
//     it calls the epilogue on 32 consecutive columns of one row (whole
//     128-byte lines of every C-shaped array it reads or writes), the
//     loads of eight elements before their stores (else each element's
//     loads wait for the previous element's stores). Unrolling a long
//     epilogue (erf, divides) over every element of the tile overflowed
//     the instruction cache: the 8 × BN form keeps one copy a half.
// Every sum has a fixed order (no atomics, no split-K): bitwise repeatable,
// whatever the grid. K and N must be multiples of 8, lda of 4 (bf16 A: 8),
// ldw of 8, A and the planes 16-byte aligned.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace te {

enum GemmMode { kBf16 = 0, kBf16x3 = 1, kBf16x3Rn = 2 };

constexpr int kGemmBK = 64;           // k per stage
constexpr int kGemmSMs = 132;         // H100 SXM: for the tile choice
constexpr int kGemmMaxStages = 4;
constexpr int kEpiPitch = 32 + 8;     // floats per staged epilogue row

// At most this many persistent blocks a launch when positive (the core's
// checks make a block walk several tiles, and several products of a
// grouped launch); 0: as many as the card holds at once.
inline int g_gemm_grid_cap = 0;

struct GemmArgs {
  const float* A;
  const uint16_t* Whi;
  const uint16_t* Wlo;   // may be null in kBf16 mode
  int lda, ldw, M, N, K;
  const uint16_t* Wahi = nullptr;   // DUAL: the planes of |W|
  const uint16_t* Walo = nullptr;
  const uint16_t* A16 = nullptr;    // gemm16: bf16 rows in A's place
};

// A B plane in a stage, BN × 64 bf16 under the 128-byte swizzle (wgmma
// layout type 1, the TMA's SWIZZLE_128B: the 16-byte chunk c of 128-byte
// row r lies at chunk position c ^ (r mod 8), so the 8 rows of an atom
// spread any one chunk position over all banks), in 1024-byte atoms of 8
// rows × 128 bytes: K-major (the B of x·Wᵀ): row n
// holds k 0..63 of W's row n, atoms stack along n (SBO 1024; LBO unused),
// k-slice s starts 32·s bytes into the row; MN-major (wgmma's transposed
// B, the B of g·W): row k holds 64 n, atom (k/8, n/64) at (n/64 · 8 + k/8)
// · 1024, so SBO (next 8 k) 1024 and LBO (next 64 n) 8192, k-slice s
// starts at atom row 2s. The TMA writes both: one box of 64 k × BN rows
// K-major, BN/64 boxes of 64 n × 64 k MN-major.
template <bool KM>
struct BPlane {
  static constexpr uint32_t LBO = KM ? 16 : 8 * 1024;
  static constexpr uint32_t SBO = 1024;
  static constexpr uint32_t SLICE = KM ? 32 : 2 * 1024;
  static constexpr int TB = KM ? 0 : 1;
};

// d += a · (slice s of the plane at shared address `plane`)
template <int BN, bool KM>
__device__ __forceinline__ void mma_slice(float (&d)[BN / 2],
                                          const uint32_t (&a)[4],
                                          uint32_t plane, int s) {
  using L = BPlane<KM>;
  wgmma_bf16<BN, L::TB>(d, a,
                        wgmma_desc128(plane + s * L::SLICE, L::LBO, L::SBO));
}

// A thread's fragments of k-slice s (k 16s..16s+15) of its rows r0 and
// r0 + 8 (the wgmma A layout), from a staged A operand:
//  - float32 rows (BM × 64) lie as two boxes of BM × 32 floats (k 0..31,
//    32..63), each row 128 bytes under the 128-byte swizzle: split into
//    bf16 (hi, lo) with round-to-nearest-even (|A| for ABS), lo only for
//    bf16×3, never written back;
//  - bf16 rows (BM × 64) lie as one box of 128-byte swizzled rows: a pair
//    of bf16 is the fragment register as it is (|A|: the sign bits
//    cleared, bf16(|x|) = |bf16(x)|).
// A quarter-warp reads one 16-byte chunk position of 8 rows, which the
// swizzle spreads over all banks.
template <int BM, bool ABS, bool X3>
__device__ __forceinline__ void frag_f32(const unsigned char* As, int r0,
                                         int s, int q, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const unsigned char* box = As + (s >> 1) * (BM * 128);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      const int chunk = (4 * (s & 1) + 2 * h + (q >> 1)) ^ (r & 7);
      const float2 v = *reinterpret_cast<const float2*>(
          box + r * 128 + chunk * 16 + 8 * (q & 1));
      const float x0 = ABS ? fabsf(v.x) : v.x;
      const float x1 = ABS ? fabsf(v.y) : v.y;
      const uint32_t hp = pack_bf16x2(x0, x1);
      hi[rr + 2 * h] = hp;
      if constexpr (X3)
        lo[rr + 2 * h] =
            pack_bf16x2(x0 - bf2f((uint16_t)hp), x1 - bf2f(hp >> 16));
    }
}

template <bool ABS>
__device__ __forceinline__ void frag_bf16(const unsigned char* As, int r0,
                                          int s, int q, uint32_t (&f)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      const int chunk = (2 * s + h) ^ (r & 7);
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(As + r * 128 + chunk * 16 + 4 * q);
      f[rr + 2 * h] = ABS ? u & 0x7FFF7FFFu : u;
    }
}

// ---------------------------------------------------------------------------
// The passes: what one tile computes from its staged operands. Each names
// its A operands (NA; float32 or bf16 rows), its B planes (NP; K-major or
// MN-major), its accumulator sets (NS) and the values its epilogue gets
// (NV), and issues a stage's wgmma: per 16-deep k-slice one commit group,
// each set's chain over k in slice order, so that an output is the same
// sum whichever pass or tile computes it.
// ---------------------------------------------------------------------------

// One A operand: the layer kernels' products (gemm.cu lists them).
//   kBf16:   set 0 += hi(A)·hi                  (DUAL: set 1 += hi(A)·|W|hi)
//   kBf16x3: set 0 += hi(A)·hi; set 1 += hi(A)·lo + lo(A)·hi (DUAL: sets
//            2, 3 the same on |W|'s planes); values set 0 + set 1 (and
//            set 2 + set 3), associated as JAX associates
//   kBf16x3Rn: set 0 += lo(A)·hi + hi(A)·lo over a k-step's slices, then
//            += hi(A)·hi over them; then set 1 += set 0 (round to nearest)
//            and set 0 = 0 (promote; DUAL: sets 2, 3 the same); values
//            set 1 (and set 3)
// A16: A as bf16 rows (kBf16 only).
template <int MODE, bool WT, bool ABS, bool DUAL, bool A16>
struct SpecStd {
  static constexpr bool X3 = MODE != kBf16, RN = MODE == kBf16x3Rn;
  static_assert(!(A16 && X3), "bf16 A rows take one-pass products");
  static constexpr int NA = 1, NS = (X3 ? 2 : 1) * (DUAL ? 2 : 1), NP = NS;
  static constexpr int NV = DUAL ? 2 : 1;
  __host__ __device__ static constexpr bool a16(int) { return A16; }
  __host__ __device__ static constexpr bool kmajor(int) { return WT; }

  template <int BM, int BN>
  static __device__ __forceinline__ void step(float (&acc)[NS][BN / 2],
                                              const unsigned char* A0,
                                              const unsigned char*,
                                              uint32_t pl, int r0, int q) {
    constexpr int P = BN * 128;
    uint32_t fr[4][X3 ? 2 : 1][4];   // [k-slice][hi, lo][reg]
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (A16)
        frag_bf16<ABS>(A0, r0, s, q, fr[s][0]);
      else
        frag_f32<BM, ABS, X3>(A0, r0, s, q, fr[s][0], fr[s][X3 ? 1 : 0]);
      wgmma_fence();
      if constexpr (RN) {   // the cross terms; hi·hi after every slice's
        mma_slice<BN, WT>(acc[0], fr[s][1], pl, s);
        mma_slice<BN, WT>(acc[0], fr[s][0], pl + P, s);
        if constexpr (DUAL) {
          mma_slice<BN, WT>(acc[2], fr[s][1], pl + 2 * P, s);
          mma_slice<BN, WT>(acc[2], fr[s][0], pl + 3 * P, s);
        }
        wgmma_commit();
        continue;
      }
      mma_slice<BN, WT>(acc[0], fr[s][0], pl, s);
      if constexpr (X3) {
        mma_slice<BN, WT>(acc[1], fr[s][0], pl + P, s);
        mma_slice<BN, WT>(acc[1], fr[s][X3 ? 1 : 0], pl, s);
      }
      if constexpr (DUAL) {
        constexpr int a = X3 ? 2 : 1;
        mma_slice<BN, WT>(acc[a], fr[s][0], pl + a * P, s);
        if constexpr (X3) {
          mma_slice<BN, WT>(acc[a + 1], fr[s][0], pl + (a + 1) * P, s);
          mma_slice<BN, WT>(acc[a + 1], fr[s][X3 ? 1 : 0], pl + a * P, s);
        }
      }
      wgmma_commit();
    }
    if constexpr (RN) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        mma_slice<BN, WT>(acc[0], fr[s][0], pl, s);
        if constexpr (DUAL) mma_slice<BN, WT>(acc[2], fr[s][0], pl + 2 * P, s);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
  }

  // after each k-step (kBf16x3Rn): its sums join the running sums
  template <int BN>
  static __device__ __forceinline__ void promote(float (&acc)[NS][BN / 2]) {
    if constexpr (RN) {
#pragma unroll
      for (int a = 0; a < NS; a += 2)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          acc[a + 1][i] += acc[a][i];
          acc[a][i] = 0.f;
        }
    }
  }

  template <int BN>
  static __device__ __forceinline__ float value(const float (&acc)[NS][BN / 2],
                                                int v, int e) {
    const int a = v == 0 ? 0 : (X3 ? 2 : 1);
    if constexpr (RN) return acc[a + 1][e];
    else if constexpr (X3) return acc[a][e] + acc[a + 1][e];
    else return acc[a][e];
  }
};

// Two A operands on one output tile, bf16 products on bf16 rows: set 0 +=
// A0·W0ᵀ (W0 K-major), set 1 += A1·W1 (W1 MN-major). B10a's first pass:
// xn2·W1ᵀ (fc1_pre) and g_out·W2.
struct SpecTwoA {
  static constexpr int NA = 2, NS = 2, NP = 2, NV = 2;
  __host__ __device__ static constexpr bool a16(int) { return true; }
  __host__ __device__ static constexpr bool kmajor(int p) { return p == 0; }

  template <int BM, int BN>
  static __device__ __forceinline__ void step(float (&acc)[NS][BN / 2],
                                              const unsigned char* A0,
                                              const unsigned char* A1,
                                              uint32_t pl, int r0, int q) {
    uint32_t f0[4][4], f1[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_bf16<false>(A0, r0, s, q, f0[s]);
      frag_bf16<false>(A1, r0, s, q, f1[s]);
      wgmma_fence();
      mma_slice<BN, true>(acc[0], f0[s], pl, s);
      mma_slice<BN, false>(acc[1], f1[s], pl + BN * 128, s);
      wgmma_commit();
    }
    wgmma_wait<0>();
  }

  template <int BN>
  static __device__ __forceinline__ void promote(float (&)[NS][BN / 2]) {}

  template <int BN>
  static __device__ __forceinline__ float value(const float (&acc)[NS][BN / 2],
                                                int v, int e) {
    return acc[v][e];
  }
};

// A dual pass whose second product takes |A|, bf16 products on bf16 A
// rows, both planes K-major: set 0 += A·W0ᵀ, set 1 += |A|·W1ᵀ. B10a's fc2
// and |hg|·|W2|ᵀ on one staged hg.
struct SpecDualAbsA {
  static constexpr int NA = 1, NS = 2, NP = 2, NV = 2;
  __host__ __device__ static constexpr bool a16(int) { return true; }
  __host__ __device__ static constexpr bool kmajor(int) { return true; }

  template <int BM, int BN>
  static __device__ __forceinline__ void step(float (&acc)[NS][BN / 2],
                                              const unsigned char* A0,
                                              const unsigned char*,
                                              uint32_t pl, int r0, int q) {
    uint32_t f[4][4], fa[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_bf16<false>(A0, r0, s, q, f[s]);
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[s][i] = f[s][i] & 0x7FFF7FFFu;
      wgmma_fence();
      mma_slice<BN, true>(acc[0], f[s], pl, s);
      mma_slice<BN, true>(acc[1], fa[s], pl + BN * 128, s);
      wgmma_commit();
    }
    wgmma_wait<0>();
  }

  template <int BN>
  static __device__ __forceinline__ void promote(float (&)[NS][BN / 2]) {}

  template <int BN>
  static __device__ __forceinline__ float value(const float (&acc)[NS][BN / 2],
                                                int v, int e) {
    return acc[v][e];
  }
};

// Three sets, bf16 products on bf16 rows: set 0 += A0·W0, set 1 += A0·W1
// (W0 and W1 MN-major: a dual pass), set 2 += |A1|·W2ᵀ (W2 K-major). B10b's
// Sr·W2, Sr·|W2| and |xn2|·|W1|ᵀ.
struct SpecThree {
  static constexpr int NA = 2, NS = 3, NP = 3, NV = 3;
  __host__ __device__ static constexpr bool a16(int) { return true; }
  __host__ __device__ static constexpr bool kmajor(int p) { return p == 2; }

  template <int BM, int BN>
  static __device__ __forceinline__ void step(float (&acc)[NS][BN / 2],
                                              const unsigned char* A0,
                                              const unsigned char* A1,
                                              uint32_t pl, int r0, int q) {
    constexpr int P = BN * 128;
    uint32_t f0[4][4], f1[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_bf16<false>(A0, r0, s, q, f0[s]);
      frag_bf16<true>(A1, r0, s, q, f1[s]);
      wgmma_fence();
      mma_slice<BN, false>(acc[0], f0[s], pl, s);
      mma_slice<BN, false>(acc[1], f0[s], pl + P, s);
      mma_slice<BN, true>(acc[2], f1[s], pl + 2 * P, s);
      wgmma_commit();
    }
    wgmma_wait<0>();
  }

  template <int BN>
  static __device__ __forceinline__ void promote(float (&)[NS][BN / 2]) {}

  template <int BN>
  static __device__ __forceinline__ float value(const float (&acc)[NS][BN / 2],
                                                int v, int e) {
    return acc[v][e];
  }
};

// One tile configuration of a pass: WG consumer warpgroups (BM = 64·WG
// rows, 64 each) × BN columns. A stage holds the pass's A operands and B
// planes for 64 k.
template <class S, int WG_, int BN_>
struct GemmTile {
  using Spec = S;
  static constexpr int WG = WG_, BN = BN_, BM = 64 * WG;
  static constexpr int NS = S::NS, NV = S::NV;
  __host__ __device__ static constexpr int a_bytes(int i) {
    return i >= S::NA ? 0 : BM * (S::a16(i) ? 128 : 256);
  }
  static constexpr int P_BYTES = BN * 128;
  static constexpr int PL = a_bytes(0) + a_bytes(1);   // planes' offset
  static constexpr int STAGE = PL + S::NP * P_BYTES;
  static_assert(BN % 64 == 0 && BN <= 192, "tile width");
  using Acc = float[NS][BN / 2];
};

// One product of a launch: its tile, its TMA maps (A operands, B planes),
// its epilogue and its extent. GemmNone: no second product.
template <class T, class E>
struct GemmItem {
  using Tile = T;
  using Epi = E;
  TmaMap a[2];
  TmaMap b[4];
  E epi;
  int M, N, K, tiles_n, tiles;
};

struct GemmNone {
  int tiles = 0;
};

// a product's stage bytes, and the floats a consumer warp stages of its
// sums: ROUND, 8 rows × 32 columns at a time; HALF, 8 rows × BN at a time
template <class I>
struct GemmItemSize {
  using T = typename I::Tile;
  static constexpr int STAGE = T::STAGE, WG = T::WG;
  static constexpr int ROUND = 8 * kEpiPitch * T::NV;
  static constexpr int HALF = 8 * (T::BN + 4) * T::NV;
};
template <>
struct GemmItemSize<GemmNone> {
  static constexpr int STAGE = 0, WG = 0, ROUND = 0, HALF = 0;
};

// A launch of one or two products (a grouped launch: independent products
// of one tile height, BM): the stage ring and the shared memory it takes,
// the block (WG consumer warpgroups and one producer warpgroup) and the
// register budgets of the two roles.
__host__ __device__ constexpr int gemm_cmax(int a, int b) {
  return a > b ? a : b;
}

// the stages (at most kGemmMaxStages) that fit beside stg_warp floats of
// epilogue staging for each of 4·wg consumer warps, at per_sm blocks an SM
__host__ __device__ constexpr int gemm_stages(int per_sm, int wg, int stage,
                                              int stg_warp) {
  const int budget = (per_sm == 1 ? 232448 : 233472 / 2 - 1024) -
                     4 * wg * stg_warp * 4 - 1024 - 16 * kGemmMaxStages;
  const int n = budget > 0 ? budget / stage : 0;
  return n < kGemmMaxStages ? n : kGemmMaxStages;
}

// An epilogue with a long body (erf, exp, divides: EpiGelu, EpiGeluGrad, the
// tensor-parallel passes') sets kLong: its staging takes the half-tile form
// even at two stages.
template <class E, class = void>
struct EpiLong : std::false_type {};
template <class E>
struct EpiLong<E, std::void_t<decltype(E::kLong)>>
    : std::integral_constant<bool, E::kLong> {};

template <class I>
constexpr bool gemm_item_long() {
  if constexpr (std::is_same<I, GemmNone>::value) return false;
  else return EpiLong<typename I::Epi>::value;
}

template <class I0, class I1>
struct GemmRing {
  static constexpr int WG = I0::Tile::WG;
  static constexpr bool TWO = !std::is_same<I1, GemmNone>::value;
  static constexpr int STAGE =
      gemm_cmax(GemmItemSize<I0>::STAGE, GemmItemSize<I1>::STAGE);
  // blocks an SM: one of two consumer warpgroups; of one, two where a
  // single-set tile's shared memory allows (gemm_small_tile's count)
  static constexpr int PER_SM =
      WG == 1 && I0::Tile::NS == 1 && !TWO ? 2 : 1;
  // the epilogue stages a half tile a warp (8 rows × BN, then a loop over
  // its 32-column pieces: one copy of the epilogue's code per half, where
  // an unrolled piece-by-piece epilogue inlines one per element, which
  // overflows the instruction cache with a long epilogue) wherever that
  // leaves the ring three stages, two for a long epilogue; else 8 × 32
  // pieces, unrolled. The small tile takes the half form only for a long
  // epilogue: its 128 registers a thread (two blocks an SM) do not hold a
  // half's prefetched inputs beside four sets of sums
  static constexpr bool LONG = gemm_item_long<I0>() || gemm_item_long<I1>();
  static constexpr bool HALF =
      (WG == 2 || LONG) &&
      gemm_stages(PER_SM, WG, STAGE,
                  gemm_cmax(GemmItemSize<I0>::HALF, GemmItemSize<I1>::HALF)) >=
          (LONG ? 2 : 3);
  static constexpr int STG_WARP =
      HALF ? gemm_cmax(GemmItemSize<I0>::HALF, GemmItemSize<I1>::HALF)
           : gemm_cmax(GemmItemSize<I0>::ROUND, GemmItemSize<I1>::ROUND);
  static constexpr int STG = 4 * WG * STG_WARP * 4;
  static constexpr int STAGES = gemm_stages(PER_SM, WG, STAGE, STG_WARP);
  static constexpr int SMEM = 1024 + STAGES * STAGE + STG + 16 * STAGES;
  static constexpr int THREADS = 128 * (WG + 1);
  // registers a thread: the launch gives every thread the same (at most
  // 65536 / THREADS, 168 at WG = 2; 128 at WG = 1, which takes a second
  // block); the producer warpgroup gives most of its own back and the
  // consumers take them
  static constexpr int MINB = WG == 1 ? 2 : 1;
  static constexpr int REG_P = 40, REG_C = WG == 1 ? 216 : 232;
  static_assert(!TWO || GemmItemSize<I1>::WG == WG,
                "a grouped launch's products share the tile height");
  static_assert(STAGES >= 2, "shared memory: two stages at least");
  static_assert(SMEM <= 232448, "shared memory");
};

template <class I0, class I1>
struct GemmGroup {
  I0 i0;
  I1 i1;
};

// The producer's copies of one tile: for each 64-deep k-step, wait for
// its stage to be empty, expect the stage's bytes on its full barrier and
// issue the TMA loads (zeros past M, N and K).
template <class R, class I>
__device__ __forceinline__ void gemm_produce(const I& it, int tile,
                                             unsigned char* sm,
                                             uint64_t* full, uint64_t* empty,
                                             int& stage, uint32_t& phase) {
  using T = typename I::Tile;
  using S = typename T::Spec;
  const int m0 = (tile / it.tiles_n) * T::BM, n0 = (tile % it.tiles_n) * T::BN;
  const int nk = (it.K + kGemmBK - 1) / kGemmBK;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&empty[stage], phase ^ 1u);
    uint64_t* bar = &full[stage];
    mbar_arrive_expect_tx(bar, T::STAGE);
    unsigned char* st = sm + stage * R::STAGE;
    const int k0 = kt * kGemmBK;
#pragma unroll
    for (int i = 0; i < S::NA; ++i) {
      unsigned char* a = st + (i == 0 ? 0 : T::a_bytes(0));
      tma_load_2d(a, &it.a[i], k0, m0, bar);
      if (!S::a16(i)) tma_load_2d(a + T::BM * 128, &it.a[i], k0 + 32, m0, bar);
    }
#pragma unroll
    for (int p = 0; p < S::NP; ++p) {
      unsigned char* b = st + T::PL + p * T::P_BYTES;
      if (S::kmajor(p)) {
        tma_load_2d(b, &it.b[p], k0, n0, bar);
      } else {
#pragma unroll
        for (int j = 0; j < T::BN / 64; ++j)
          tma_load_2d(b + j * 8192, &it.b[p], n0 + 64 * j, k0, bar);
      }
    }
    if (++stage == R::STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

// the epilogue on one element, its NV values staged P floats apart
template <int NV, int P, class E>
__device__ __forceinline__ void gemm_epi_call(const E& epi, int r, int c,
                                              const float* v,
                                              const typename E::In& in) {
  if constexpr (NV == 1) epi(r, c, v[0], 0.f, in);
  else if constexpr (NV == 2) epi(r, c, v[0], v[P], in);
  else epi(r, c, v[0], v[P], v[2 * P], in);
}

// one warp's epilogue on 8 rows × 32 columns (column c a lane): the loads
// of the eight elements' inputs, then the stores from their staged values
// (row pitch HP) and those inputs
constexpr int kEpiRows = 8;

template <class I>
__device__ __forceinline__ void gemm_epi_load(
    const I& it, typename I::Epi::In (&in)[kEpiRows], int r0, int c) {
#pragma unroll
  for (int u = 0; u < kEpiRows; ++u)
    if (r0 + u < it.M && c < it.N) in[u] = it.epi.load(r0 + u, c);
}

template <int NV, int HP, class I>
__device__ __forceinline__ void gemm_epi_store(
    const I& it, const typename I::Epi::In (&in)[kEpiRows], const float* ws,
    int r0, int c) {
#pragma unroll
  for (int u = 0; u < kEpiRows; ++u)
    if (r0 + u < it.M && c < it.N)
      gemm_epi_call<NV, 8 * HP>(it.epi, r0 + u, c, ws + u * HP, in[u]);
}

// A consumer warpgroup's share of one tile: for each k-step wait for its
// stage, run the pass's wgmma on it and release it (each warp once its
// reads are done); then the epilogue, staged per warp through its own
// shared memory (GemmRing::HALF) so that the warp calls it on 32
// consecutive columns of one row (whole 128-byte lines of every C-shaped
// array), the loads of eight elements before their stores (else each
// element's loads wait for the previous element's stores; an epilogue
// writes no element that another reads, so the next piece's loads may go
// ahead of this piece's stores). No block-wide
// barrier: the producer fills the next tile's stages meanwhile.
template <class R, class I>
__device__ __forceinline__ void gemm_consume(const I& it, int tile,
                                             unsigned char* sm, float* stg,
                                             uint64_t* full, uint64_t* empty,
                                             int& stage, uint32_t& phase,
                                             int t) {
  using T = typename I::Tile;
  using S = typename T::Spec;
  constexpr int BN = T::BN, NV = T::NV;
  const int m0 = (tile / it.tiles_n) * T::BM, n0 = (tile % it.tiles_n) * BN;
  const int nk = (it.K + kGemmBK - 1) / kGemmBK;
  const int lane = t & 31, gi = lane >> 2, q = lane & 3;
  const int wrow = (t >> 7) * 64 + ((t >> 5) & 3) * 16;   // the warp's rows
  const int r0 = wrow + gi;

  typename T::Acc acc;
#pragma unroll
  for (int s = 0; s < T::NS; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = sm + stage * R::STAGE;
    S::template step<T::BM, BN>(acc, st, st + T::a_bytes(0),
                                smem_u32(st + T::PL), r0, q);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    S::template promote<BN>(acc);
    if (++stage == R::STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }

  float* const ws = stg + (t >> 5) * R::STG_WARP;
  using In = typename I::Epi::In;
  if constexpr (R::HALF) {
    // a half at a time: stage its sums, then a loop over its 32-column
    // pieces, each piece's inputs loaded while the previous piece stores
    // (its first piece's before the staging)
    constexpr int HP = BN + 4;        // staged row pitch: 2 wavefronts a write
    constexpr int NJ = BN / 32;
    In cur[kEpiRows];
    gemm_epi_load(it, cur, m0 + wrow, n0 + lane);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r0 = m0 + wrow + 8 * rr;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int e = 4 * j + 2 * rr;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          *reinterpret_cast<float2*>(ws + v * 8 * HP + gi * HP + 8 * j +
                                     2 * q) =
              float2{S::template value<BN>(acc, v, e),
                     S::template value<BN>(acc, v, e + 1)};
      }
      __syncwarp();
#pragma unroll 1
      for (int j32 = 0; j32 < NJ; ++j32) {
        In nxt[kEpiRows];
        if (j32 + 1 < NJ)
          gemm_epi_load(it, nxt, r0, n0 + 32 * (j32 + 1) + lane);
        else if (rr == 0)
          gemm_epi_load(it, nxt, r0 + 8, n0 + lane);
        gemm_epi_store<NV, HP>(it, cur, ws + 32 * j32 + lane, r0,
                               n0 + 32 * j32 + lane);
#pragma unroll
        for (int u = 0; u < kEpiRows; ++u) cur[u] = nxt[u];
      }
      __syncwarp();
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int j32 = 0; j32 < BN / 32; ++j32) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int e = 4 * (4 * j32 + jj) + 2 * rr;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            *reinterpret_cast<float2*>(ws + v * 8 * kEpiPitch +
                                       gi * kEpiPitch + 8 * jj + 2 * q) =
                float2{S::template value<BN>(acc, v, e),
                       S::template value<BN>(acc, v, e + 1)};
        }
        __syncwarp();
        const int r0 = m0 + wrow + 8 * rr, c = n0 + 32 * j32 + lane;
        In in[kEpiRows];
        gemm_epi_load(it, in, r0, c);
        gemm_epi_store<NV, kEpiPitch>(it, in, ws + lane, r0, c);
        __syncwarp();
      }
    }
  }
}

// The core's kernel: a persistent grid (at most the blocks the card holds
// at once) walks the tiles of one or two products in a fixed order (the
// first product's, then the second's; n fastest), block b taking tiles b,
// b + grid, ... One producer warpgroup (a single thread issues the TMA
// loads) keeps a ring of STAGES stages full, running ahead into the next
// tile while the consumers run this one's epilogue; the WG consumer
// warpgroups wait on each stage's full barrier and release it on its
// empty barrier. Every output's sums have a fixed order (no atomics, no
// split-K): bitwise repeatable, and the same for any grid.
template <class I0, class I1>
__global__ void __launch_bounds__(GemmRing<I0, I1>::THREADS,
                                  GemmRing<I0, I1>::MINB)
gemm_kernel(const __grid_constant__ GemmGroup<I0, I1> g) {
  using R = GemmRing<I0, I1>;
  // the stages from the first 1024-byte boundary (the swizzle atoms')
  unsigned char* const sm =
      te_smem + ((1024 - (smem_u32(te_smem) & 1023)) & 1023);
  float* const stg = reinterpret_cast<float*>(sm + R::STAGES * R::STAGE);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(sm + R::STAGES * R::STAGE + R::STG);
  uint64_t* const empty = full + R::STAGES;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * R::WG);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int total = g.i0.tiles + g.i1.tiles;
  int stage = 0;
  uint32_t phase = 0;
  if (t >= 128 * R::WG) {
    setmaxnreg_dec<R::REG_P>();
    if (t == 128 * R::WG) {
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        if (i < g.i0.tiles) {
          gemm_produce<R>(g.i0, i, sm, full, empty, stage, phase);
        } else {
          if constexpr (R::TWO)
            gemm_produce<R>(g.i1, i - g.i0.tiles, sm, full, empty, stage,
                            phase);
        }
      }
    }
  } else {
    setmaxnreg_inc<R::REG_C>();
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      if (i < g.i0.tiles) {
        gemm_consume<R>(g.i0, i, sm, stg, full, empty, stage, phase, t);
      } else {
        if constexpr (R::TWO)
          gemm_consume<R>(g.i1, i - g.i0.tiles, sm, stg, full, empty, stage,
                          phase, t);
      }
    }
  }
}

// Fills one product of a launch: its epilogue, extent and tile count, and
// a TMA map for each A operand (float32 in boxes of 32 k, bf16 in boxes of
// 64 k, BM rows) and each B plane (K-major W (N, K): boxes of 64 k × BN
// rows; MN-major W (K, N): boxes of 64 n × 64 k). lda, ldw in elements.
template <class T, class E>
int gemm_item(GemmItem<T, E>& it, const E& epi, int M, int N, int K,
              const void* const (&a)[2], const int (&lda)[2],
              const uint16_t* const (&b)[4], const int (&ldw)[4]) {
  using S = typename T::Spec;
  it.epi = epi;
  it.M = M;
  it.N = N;
  it.K = K;
  it.tiles_n = (N + T::BN - 1) / T::BN;
  it.tiles = M > 0 && N > 0 && K > 0 ? ((M + T::BM - 1) / T::BM) * it.tiles_n
                                     : 0;
  if (it.tiles == 0) return 0;
  for (int i = 0; i < S::NA; ++i) {
    const int es = S::a16(i) ? 2 : 4;
    const int err = tma_map_2d(&it.a[i], a[i], es, K, M,
                               (uint64_t)lda[i] * es, 128 / es, T::BM);
    if (err) return err;
  }
  for (int p = 0; p < S::NP; ++p) {
    const int err =
        S::kmajor(p)
            ? tma_map_2d(&it.b[p], b[p], 2, K, N, (uint64_t)ldw[p] * 2, 64,
                         T::BN)
            : tma_map_2d(&it.b[p], b[p], 2, N, K, (uint64_t)ldw[p] * 2, 64,
                         64);
    if (err) return err;
  }
  return 0;
}

// Launches one product, or two in one grouped launch.
template <class I0, class I1 = GemmNone>
int gemm_run(const I0& i0, cudaStream_t stream, const I1& i1 = I1{}) {
  using R = GemmRing<I0, I1>;
  const int total = i0.tiles + i1.tiles;
  if (total == 0) return (int)cudaSuccess;
  auto kern = gemm_kernel<I0, I1>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int fit = 233472 / (R::SMEM + 1024);
  int grid = sms * (fit < R::PER_SM ? (fit > 0 ? fit : 1) : R::PER_SM);
  if (grid > total) grid = total;
  if (g_gemm_grid_cap > 0 && grid > g_gemm_grid_cap) grid = g_gemm_grid_cap;
  const GemmGroup<I0, I1> g{i0, i1};
  TE_LAUNCH(kern, grid, R::THREADS, R::SMEM, stream)(g);
  return (int)cudaGetLastError();
}

// The tile for an (M, N) product with ns accumulator sets: the large one
// (2 warpgroups, 128 × 192 / 128 / 64 for 1 / 2 / 4 sets) or the small one
// (1 warpgroup, 64 × 128 / 128 / 64), whichever takes less time: SM-waves
// times the work of one wave, the small tile's weighted by its measured
// cost per element. A pure function of the shape and the sets, so every
// caller of a shape runs the same tile.
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

template <int MODE, bool WT, bool ABS, bool DUAL, bool A16, int WG, int BN,
          class Epi>
int gemm_launch(const GemmArgs& g, const Epi& epi, cudaStream_t stream) {
  using T = GemmTile<SpecStd<MODE, WT, ABS, DUAL, A16>, WG, BN>;
  constexpr bool X3 = MODE != kBf16;
  GemmItem<T, Epi> it;
  const uint16_t* w[4] = {g.Whi, nullptr, nullptr, nullptr};
  if constexpr (X3) w[1] = g.Wlo;
  if constexpr (DUAL) {
    w[X3 ? 2 : 1] = g.Wahi;
    if constexpr (X3) w[3] = g.Walo;
  }
  const void* a = A16 ? static_cast<const void*>(g.A16)
                      : static_cast<const void*>(g.A);
  const int err = gemm_item(it, epi, g.M, g.N, g.K, {a, nullptr},
                            {g.lda, 0}, w, {g.ldw, g.ldw, g.ldw, g.ldw});
  if (err) return err;
  return gemm_run(it, stream);
}

template <int MODE, bool WT, bool ABS, bool DUAL, bool A16, class Epi>
int gemm_tiled(const GemmArgs& g, const Epi& epi, cudaStream_t stream,
               int tile) {
  constexpr int NS = (MODE != kBf16 ? 2 : 1) * (DUAL ? 2 : 1);
  constexpr int BIG = NS == 1 ? 192 : NS == 2 ? 128 : 64;
  constexpr int SMALL = NS == 4 ? 64 : 128;
  const bool small = tile < 0 ? gemm_small_tile(g.M, g.N, NS) : tile == 1;
  return small
             ? gemm_launch<MODE, WT, ABS, DUAL, A16, 1, SMALL>(g, epi, stream)
             : gemm_launch<MODE, WT, ABS, DUAL, A16, 2, BIG>(g, epi, stream);
}

inline bool gemm_misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// what every launch needs: K and N multiples of 8, pitches of 16 bytes,
// 16-byte aligned operands, the planes the mode names
inline bool gemm_args_ok(const GemmArgs& g, bool a16, bool dual) {
  const bool a_ok = a16 ? g.A16 != nullptr && g.lda % 8 == 0 &&
                              !gemm_misaligned(g.A16)
                        : g.A != nullptr && g.lda % 4 == 0 &&
                              !gemm_misaligned(g.A);
  return a_ok && g.K % 8 == 0 && g.N % 8 == 0 && g.ldw % 8 == 0 &&
         g.lda >= g.K && g.Whi != nullptr && !gemm_misaligned(g.Whi) &&
         !gemm_misaligned(g.Wlo) && !gemm_misaligned(g.Wahi) &&
         !gemm_misaligned(g.Walo) && (!dual || g.Wahi != nullptr);
}

// Launch in the mode the caller names; kBf16x3 needs the lo planes, DUAL
// the planes of |W|. tile: -1 the shape's tile (gemm_small_tile), 0 the
// large one, 1 the small one (the core's own checks cross both).
template <bool WT, bool ABS, bool DUAL, class Epi>
int gemm(int mode, const GemmArgs& g, const Epi& epi, cudaStream_t stream,
         int tile = -1) {
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return (int)cudaSuccess;
  if (!gemm_args_ok(g, false, DUAL)) return (int)cudaErrorInvalidValue;
  if (mode == kBf16)
    return gemm_tiled<kBf16, WT, ABS, DUAL, false>(g, epi, stream, tile);
  if (mode == kBf16x3 && g.Wlo != nullptr && (!DUAL || g.Walo != nullptr))
    return gemm_tiled<kBf16x3, WT, ABS, DUAL, false>(g, epi, stream, tile);
  return (int)cudaErrorInvalidValue;
}

// An MLP product in the MLP mode: a one-pass product as gemm() runs it, a
// bf16×3 one as kBf16x3Rn (C5, above)
template <bool WT, bool ABS, bool DUAL, class Epi>
int gemm_mlp(int mode, const GemmArgs& g, const Epi& epi,
             cudaStream_t stream, int tile = -1) {
  if (mode != kBf16x3) return gemm<WT, ABS, DUAL>(mode, g, epi, stream, tile);
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return (int)cudaSuccess;
  if (!gemm_args_ok(g, false, DUAL) || g.Wlo == nullptr ||
      (DUAL && g.Walo == nullptr))
    return (int)cudaErrorInvalidValue;
  return gemm_tiled<kBf16x3Rn, WT, ABS, DUAL, false>(g, epi, stream, tile);
}

// The same product with A as bf16 rows (g.A16, pitch lda), one pass: what
// gemm<..>(kBf16, ..) gives on float32 rows whose bf16 rounding they are.
template <bool WT, bool ABS, bool DUAL, class Epi>
int gemm16(const GemmArgs& g, const Epi& epi, cudaStream_t stream,
           int tile = -1) {
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return (int)cudaSuccess;
  if (!gemm_args_ok(g, true, DUAL)) return (int)cudaErrorInvalidValue;
  return gemm_tiled<kBf16, WT, ABS, DUAL, true>(g, epi, stream, tile);
}

// The fused passes (SpecTwoA, SpecDualAbsA, SpecThree) and the products of
// a grouped launch take the large tile, 128 rows × 192 / 128 / 64 columns
// for 1 / 2 / 3 sets (a pure function of the sets), so that any two share
// a launch; the persistent grid fills the card.
template <class S>
using FusedTile = GemmTile<S, 2, S::NS == 1 ? 192 : S::NS == 2 ? 128 : 64>;

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

// xn = (x − μ)·inv·s + b (JAX _ln_fwd), rows of width D; a bf16 xn is the
// float32 value rounded to nearest even (what a one-pass product takes)
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(uint16_t* p, float v) {
  *p = f2bf(v);
}

// With y16 set, the same rows of a second (rows, D) array y are stored
// rounded to bf16 beside it (the other one-pass A operand of the caller's
// next product).
template <typename O>
static __global__ void __launch_bounds__(kRowWarps * kWarp)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ b, O* __restrict__ xn, int rows,
              int D, float eps, const float* __restrict__ y,
              uint16_t* __restrict__ y16) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * D;
  float mu, inv;
  ln_stats(xr, D, eps, lane, mu, inv);
  for (int c = lane; c < D; c += kWarp)
    store_as(xn + (size_t)row * D + c,
             add_rn(mul_rn(mul_rn(xr[c] - mu, inv), s[c]), b[c]));
  if (y16 != nullptr)
    for (int c = lane; c < D; c += kWarp)
      y16[(size_t)row * D + c] = f2bf(y[(size_t)row * D + c]);
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

template <typename O>
inline int ln_fwd(const float* x, const float* s, const float* b, O* xn,
                  int rows, int D, float eps, cudaStream_t stream,
                  const float* y = nullptr, uint16_t* y16 = nullptr) {
  TE_LAUNCH(ln_fwd_kernel<O>, (rows + kRowWarps - 1) / kRowWarps,
            kRowWarps * kWarp, 0, stream)(x, s, b, xn, rows, D, eps, y, y16);
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
  static constexpr bool kLong = true;
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
