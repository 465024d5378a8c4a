// The MLP half of the ViT reverse step (_mlp_rev_math of
// transformer_explainability_tpu/ops/pallas_kernels.py), shared by the
// whole-block reverse (block_rev.cu) and the split-path MLP reverse
// (mlp_rev.cu), so that the two cannot drift. From the LN2 output xn2 and the
// forward anchors fc1_pre, fc2_pre of the block's MLP:
//   g_h1 = (g_out·W2) ⊙ gelu′(h1) and hg = gelu(h1), h1 = fc1_pre + b1
//     (mlp mode); g_xn2 = g_h1·W1 (mlp); g_mid = g_out + LN2 backward;
//   the add2 rule (Ca, Cb) of x_mid + (fc2_pre + b2) with per-sample sums;
//   the fc2 α-β rule: Sr = safe_divide(Cb, (fc2_pre + |hg|·|W2|ᵀ) / 2), then
//     R2 = (hg ⊙ Sr·W2 + |hg| ⊙ Sr·|W2|) / 2 (rule mode, one dual GEMM);
//   the fc1 α-β rule the same way on xn2 and W1, its dual GEMM's epilogue
//     merging with Ca in the clone: Rm = x_mid ⊙ safe_divide(Ca + R2b, x_mid).
#pragma once

#include "rules.cuh"

namespace te {

// The half's scratch in the caller's workspace; t_M, t_D and partials may be
// reused by the caller once the half has run.
struct MlpRevWork {
  float* t_M;        // (rows, M): g_h1, then the fc1 rule's S
  float* hg;         // (rows, M)
  float* R2;         // (rows, M)
  float* t_D;        // (rows, D): g_xn2
  float* Ca;         // (rows, D)
  float* Cb;
  float* Sr;
  float* partials;   // (B, kAddChunks, 3)
  MlpRevWork(Carve& ws, int B, size_t rows, int D, int M)
      : t_M(ws.take<float>(rows * M)), hg(ws.take<float>(rows * M)),
        R2(ws.take<float>(rows * M)), t_D(ws.take<float>(rows * D)),
        Ca(ws.take<float>(rows * D)), Cb(ws.take<float>(rows * D)),
        Sr(ws.take<float>(rows * D)),
        partials(ws.take<float>((size_t)B * kAddChunks * 3)) {}
};

// Uses w.ln2s, w.b1, w.b2 and the (hi, lo) planes of W1 and W2 and of
// |W1| and |W2|. x_mid,
// xn2, g_out, R (B·n, D); fc1_pre (B·n, M), fc2_pre (B·n, D).
inline int mlp_rev_half(const float* x_mid, const float* xn2,
                        const float* g_out, const float* R,
                        const float* fc1_pre, const float* fc2_pre,
                        const BlockWeights& w, const MlpRevWork& s,
                        float* g_mid, float* Rm, int B, int n, int D, int M,
                        float eps, int mlp, int rule, cudaStream_t stream) {
  const int rows = B * n;
  TE_TRY(gemm<false, false, false>(
      mlp, GemmArgs{g_out, w.w2_hi, w.w2_lo, D, M, rows, M, D},
      EpiGeluGrad{s.t_M, s.hg, fc1_pre, w.b1, M}, stream));
  TE_TRY(gemm<false, false, false>(
      mlp, GemmArgs{s.t_M, w.w1_hi, w.w1_lo, M, D, rows, D, M},
      EpiStore{s.t_D, D}, stream));
  TE_TRY(ln_bwd(s.t_D, x_mid, w.ln2s, g_out, g_mid, rows, D, eps, stream));
  TE_TRY(add_rule(x_mid, fc2_pre, w.b2, R, s.partials, s.Ca, s.Cb, B, n, D,
                  stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{s.hg, w.w2_ahi, w.w2_alo, M, M, rows, D, M},
      EpiRuleDen{s.Sr, s.Cb, fc2_pre, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{s.Sr, w.w2_hi, w.w2_lo, D, M, rows, M, D, w.w2_ahi,
                     w.w2_alo},
      EpiRuleNum{s.R2, s.hg, M}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{xn2, w.w1_ahi, w.w1_alo, D, D, rows, M, D},
      EpiRuleDen{s.t_M, s.R2, fc1_pre, M}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{s.t_M, w.w1_hi, w.w1_lo, M, D, rows, D, M, w.w1_ahi,
                     w.w1_alo},
      EpiRuleClone{Rm, xn2, s.Ca, x_mid, D}, stream));
  return 0;
}

}  // namespace te
