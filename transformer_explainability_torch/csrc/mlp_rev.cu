// mlp_rev_core: the MLP half of the ViT reverse step on the split path.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// mlp_rev_core (_mlp_rev_kernel / _mlp_rev_math), one Pallas program per
// sample with W1, W2 and every (n, M) tensor in VMEM. The JAX ViT reverse
// runs it where the MLP kernel is allowed and the whole-block kernel is not
// (models/vit.py kstep), with the attention half in attn_rev_core. From the
// midpoint x_mid, the cotangent g_out and the relevance R at the block
// output it computes (g_mid, Rm):
//   xn2 = LN2(x_mid); fc1_pre = xn2·W1ᵀ and hg = gelu(fc1_pre + b1) (mlp
//     mode; block_fwd.cu's fc1 epilogue, so the recomputed anchors are
//     formed by the forward's own expressions); fc2_pre = hg·W2ᵀ (mlp);
//   then the MLP half of block_rev.cu (mlp_rev.cuh): the backward to g_mid,
//     the add2 rule, the fc2 and fc1 α-β rules (rule mode) and the clone.
// Variant "ours" at α = 1, the only form the JAX kernel takes. Weights are
// the nn.Linear layouts W1 (M, D) and W2 (D, M) as bf16 (hi, lo) planes (lo
// null for one-pass modes).
//
// What bounds it on the H100: as in block_rev.cu, W1, W2 and the (B·n, M)
// intermediates do not fit in shared memory, so the step is a sequence of
// launches over the whole batch through one workspace: two LayerNorm row
// kernels (forward here, backward in the half), ten products in eight
// GEMM-core launches (two dual GEMMs carry two products each), and the two
// passes of the add rule. The products (2·B·n·D·M FLOP each, times the
// passes of its mode) bound it: 0.075 ms at the tensor cores' rate at
// ViT-B/16 B=8 in bf16 modes; on an H100 at 700 W the GEMM-core launches
// take 0.48 of the call's 0.52 ms, their epilogues much of that. Every sum
// has a fixed order (no atomics): the outputs are bitwise repeatable.
#include "mlp_rev.cuh"

namespace te {

int mlp_rev(const float* x_mid, const float* g_out, const float* R,
            const BlockWeights& w, float* g_mid, float* Rm, char* work,
            size_t* work_bytes, int B, int n, int D, int M, float eps,
            int mlp, int rule, cudaStream_t stream) {
  const size_t rows = (size_t)B * n;
  Carve ws{work};
  float* xn2 = ws.take<float>(rows * D);
  float* fc1_pre = ws.take<float>(rows * M);
  float* fc2_pre = ws.take<float>(rows * D);
  const MlpRevWork mw(ws, B, rows, D, M);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const int r = (int)rows;
  TE_TRY(ln_fwd(x_mid, w.ln2s, w.ln2b, xn2, r, D, eps, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{xn2, w.w1_hi, w.w1_lo, D, D, r, M, D},
      EpiGelu{fc1_pre, mw.hg, w.b1, M}, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{mw.hg, w.w2_hi, w.w2_lo, M, M, r, D, M},
      EpiStore{fc2_pre, D}, stream));
  return mlp_rev_half(x_mid, xn2, g_out, R, fc1_pre, fc2_pre, w, mw, g_mid,
                      Rm, B, n, D, M, eps, mlp, rule, stream);
}

}  // namespace te

// Plain C entry point (float32). Pointers: x_mid, g_out, R; ln2s, ln2b, b1,
// b2; the (hi, lo) planes of W1 and W2, then of |W1| and |W2|; the outputs
// g_mid, Rm; the workspace (null: only write its size to *work_bytes).
// Modes: mlp (the recompute and backward products) and rule (the rule
// products) 0 = bf16, 1 = bf16×3.
extern "C" int te_mlp_rev_f32(
    const void* x_mid, const void* g_out, const void* R, const void* ln2s,
    const void* ln2b, const void* b1, const void* b2, const void* w1_hi,
    const void* w1_lo, const void* w2_hi, const void* w2_lo,
    const void* w1_ahi, const void* w1_alo, const void* w2_ahi,
    const void* w2_alo, void* g_mid,
    void* Rm, void* work, void* work_bytes, int B, int n, int D, int M,
    double eps, int mlp, int rule, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{nullptr, nullptr, static_cast<F>(ln2s),
                     static_cast<F>(ln2b), nullptr, nullptr,
                     static_cast<F>(b1), static_cast<F>(b2), nullptr, nullptr,
                     nullptr, nullptr, static_cast<W>(w1_hi),
                     static_cast<W>(w1_lo), static_cast<W>(w2_hi),
                     static_cast<W>(w2_lo)};
  w.w1_ahi = static_cast<W>(w1_ahi);
  w.w1_alo = static_cast<W>(w1_alo);
  w.w2_ahi = static_cast<W>(w2_ahi);
  w.w2_alo = static_cast<W>(w2_alo);
  return te::mlp_rev(static_cast<F>(x_mid), static_cast<F>(g_out),
                     static_cast<F>(R), w, static_cast<float*>(g_mid),
                     static_cast<float*>(Rm), static_cast<char*>(work),
                     static_cast<size_t*>(work_bytes), B, n, D, M, (float)eps,
                     mlp, rule, static_cast<cudaStream_t>(stream));
}
