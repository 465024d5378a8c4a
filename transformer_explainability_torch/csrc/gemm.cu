// The GEMM core (gemm.cuh) alone, with store epilogues: the entries that
// hold the core to its plain version (precision.kdot on the same split
// operands) in the tests and in chip_smoke.py, and time it there at the
// main paths' shapes. Every instance the layer kernels launch is here:
// (WT, ABS, DUAL) = (1, 0, 0) the forward products x·Wᵀ, (0, 0, 0) the
// backward products g·W, (1, 1, 0) the rule denominators |x|·|W|ᵀ, (0, 0, 1)
// the rule numerators S·W and S·|W|, each in both modes, the last two also
// on bf16 A rows (gemm16); and the fused passes and the grouped launch of
// the tensor-parallel MLP kernels (mlp_rev_tp.cu).
#include "rules.cuh"

namespace te {

template <bool WT, bool ABS, bool DUAL>
int gemm_store(int mode, const GemmArgs& g, float* C, float* C_abs,
               int tile, cudaStream_t stream) {
  if constexpr (DUAL)
    return gemm<WT, ABS, DUAL>(mode, g, EpiStore2{C, C_abs, g.N}, stream,
                               tile);
  else
    return gemm<WT, ABS, DUAL>(mode, g, EpiStore{C, g.N}, stream, tile);
}

// the three values of SpecThree's pass, stored apart
struct EpiStore3 {
  float* C0; float* C1; float* C2; int N;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int r, int c, float a, float b, float d,
                             const In&) const {
    const size_t o = (size_t)r * N + c;
    C0[o] = a;
    C1[o] = b;
    C2[o] = d;
  }
};

template <class S, class E>
int fused_store(const E& epi, int M, int N, int K, const void* a0,
                const void* a1, const uint16_t* p0, const uint16_t* p1,
                const uint16_t* p2, int lda0, int lda1, int ldw0, int ldw1,
                int ldw2, cudaStream_t stream) {
  GemmItem<FusedTile<S>, E> it;
  TE_TRY(gemm_item(it, epi, M, N, K, {a0, a1}, {lda0, lda1},
                   {p0, p1, p2, nullptr}, {ldw0, ldw1, ldw2, 0}));
  return gemm_run(it, stream);
}

}  // namespace te

// Plain C entry point (float32 A and C). Pointers: A (M, K) with row pitch
// lda, float32, or bf16 with a16 (mode 0 and (wt, absolute) = (0, 0) only);
// the planes (hi, lo) of the weight operand (lo null in mode 0: bf16; mode
// 1: bf16×3), W (N, K) with wt, (K, N) without, row pitch ldw; with dual
// the planes of |W| (ahi, alo); C (M, N) and, with dual, C_abs (M, N). With
// absolute the kernel takes |A| and the caller passes |W|'s planes as (hi,
// lo). tile: -1 the tile the layer kernels would take for this shape, 0 the
// large tile, 1 the small one.
extern "C" int te_gemm_f32(const void* A, const void* w_hi, const void* w_lo,
                           const void* w_ahi, const void* w_alo, void* C,
                           void* C_abs, int M, int N, int K, int lda, int ldw,
                           int mode, int wt, int absolute, int dual, int tile,
                           int a16, void* stream) {
  using W = const uint16_t*;
  te::GemmArgs g{static_cast<const float*>(A), static_cast<W>(w_hi),
                 static_cast<W>(w_lo), lda, ldw, M, N, K,
                 static_cast<W>(w_ahi), static_cast<W>(w_alo)};
  float* c = static_cast<float*>(C);
  float* ca = static_cast<float*>(C_abs);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a16) {
    if (mode != te::kBf16 || wt || absolute)
      return (int)cudaErrorInvalidValue;
    g.A16 = static_cast<W>(A);
    g.A = nullptr;
    if (dual)
      return te::gemm16<false, false, true>(g, te::EpiStore2{c, ca, N}, s,
                                            tile);
    return te::gemm16<false, false, false>(g, te::EpiStore{c, N}, s, tile);
  }
  if (wt && !absolute && !dual)
    return te::gemm_store<true, false, false>(mode, g, c, ca, tile, s);
  if (!wt && !absolute && !dual)
    return te::gemm_store<false, false, false>(mode, g, c, ca, tile, s);
  if (wt && absolute && !dual)
    return te::gemm_store<true, true, false>(mode, g, c, ca, tile, s);
  if (!wt && !absolute && dual)
    return te::gemm_store<false, false, true>(mode, g, c, ca, tile, s);
  return (int)cudaErrorInvalidValue;
}

// The fused passes alone, bf16 products (mode 0; they take no other),
// C0..C2 (M, N) float32:
//   kind 0 (SpecTwoA): C0 = a0·p0ᵀ (a0 bf16 (M, K), p0 (N, K)), C1 = a1·p1
//     (a1 bf16 (M, K), p1 (K, N));
//   kind 1 (SpecDualAbsA): C0 = a0·p0ᵀ, C1 = |a0|·p1ᵀ (a0 bf16, p0 and p1
//     (N, K));
//   kind 2 (SpecThree): C0 = a0·p0, C1 = a0·p1 (a0 bf16, p0 and p1 (K, N)),
//     C2 = |a1|·p2ᵀ (a1 bf16, p2 (N, K));
//   kind 3, a grouped launch of kind 1 (C0, C1) and C2 = a1·p2 (a1 bf16,
//     p2 (K, N)).
// lda0, lda1, ldw0..2: row pitches in elements.
extern "C" int te_gemm_fused_f32(int kind, int mode, const void* a0,
                                 const void* a1,
                                 const void* p0, const void* p1,
                                 const void* p2, void* C0, void* C1, void* C2,
                                 int M, int N, int K, int lda0, int lda1,
                                 int ldw0, int ldw1, int ldw2, void* stream) {
  using W = const uint16_t*;
  float* c0 = static_cast<float*>(C0);
  float* c1 = static_cast<float*>(C1);
  float* c2 = static_cast<float*>(C2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode != te::kBf16 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0:
      return te::fused_store<te::SpecTwoA>(
          te::EpiStore2{c0, c1, N}, M, N, K, a0, a1, static_cast<W>(p0),
          static_cast<W>(p1), nullptr, lda0, lda1, ldw0, ldw1, 0, s);
    case 1:
      return te::fused_store<te::SpecDualAbsA>(
          te::EpiStore2{c0, c1, N}, M, N, K, a0, nullptr, static_cast<W>(p0),
          static_cast<W>(p1), nullptr, lda0, 0, ldw0, ldw1, 0, s);
    case 2:
      return te::fused_store<te::SpecThree>(
          te::EpiStore3{c0, c1, c2, N}, M, N, K, a0, a1, static_cast<W>(p0),
          static_cast<W>(p1), static_cast<W>(p2), lda0, lda1, ldw0, ldw1,
          ldw2, s);
    case 3: {
      using G = te::SpecStd<te::kBf16, false, false, false, true>;
      te::GemmItem<te::FusedTile<te::SpecDualAbsA>, te::EpiStore2> i0;
      te::GemmItem<te::FusedTile<G>, te::EpiStore> i1;
      TE_TRY(te::gemm_item(i0, te::EpiStore2{c0, c1, N}, M, N, K,
                           {a0, nullptr}, {lda0, 0},
                           {static_cast<W>(p0), static_cast<W>(p1), nullptr,
                            nullptr},
                           {ldw0, ldw1, 0, 0}));
      TE_TRY(te::gemm_item(i1, te::EpiStore{c2, N}, M, N, K, {a1, nullptr},
                           {lda1, 0},
                           {static_cast<W>(p2), nullptr, nullptr, nullptr},
                           {ldw2, 0, 0, 0}));
      return te::gemm_run(i0, s, i1);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Caps the persistent grid of every later launch of the core at `blocks`
// (0: as many blocks as the card holds at once), so that the checks make
// a block walk several tiles; returns the previous cap.
extern "C" int te_gemm_grid_cap(int blocks) {
  const int prev = te::g_gemm_grid_cap;
  te::g_gemm_grid_cap = blocks;
  return prev;
}
