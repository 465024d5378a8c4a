// The GEMM core (gemm.cuh) alone, with a store epilogue: the entry that
// holds the core to its plain version (precision.kdot on the same split
// operands) in the tests and in chip_smoke.py, and times it there at the
// main paths' shapes. Every instance the layer kernels launch is here:
// (WT, ABS, DUAL) = (1, 0, 0) the forward products x·Wᵀ, (0, 0, 0) the
// backward products g·W, (1, 1, 0) the rule denominators |x|·|W|ᵀ, (0, 0, 1)
// the rule numerators S·W and S·|W|, each in both modes.
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

}  // namespace te

// Plain C entry point (float32 A and C). Pointers: A (M, K) with row pitch
// lda; the planes (hi, lo) of the weight operand (lo null in mode 0: bf16;
// mode 1: bf16×3), W (N, K) with wt, (K, N) without, row pitch ldw; with
// dual the planes of |W| (ahi, alo); C (M, N) and, with dual, C_abs (M, N).
// With absolute the kernel takes |A| and the caller passes |W|'s planes as
// (hi, lo). tile: -1 the tile the layer kernels would take for this shape, 0
// the large tile, 1 the small one.
extern "C" int te_gemm_f32(const void* A, const void* w_hi, const void* w_lo,
                           const void* w_ahi, const void* w_alo, void* C,
                           void* C_abs, int M, int N, int K, int lda, int ldw,
                           int mode, int wt, int absolute, int dual, int tile,
                           void* stream) {
  using W = const uint16_t*;
  const te::GemmArgs g{static_cast<const float*>(A), static_cast<W>(w_hi),
                       static_cast<W>(w_lo), lda, ldw, M, N, K,
                       static_cast<W>(w_ahi), static_cast<W>(w_alo)};
  float* c = static_cast<float*>(C);
  float* ca = static_cast<float*>(C_abs);
  const auto s = static_cast<cudaStream_t>(stream);
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
