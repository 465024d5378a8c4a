// bert_out_rev_core: the reverse of a BERT layer's output sub-block.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// bert_out_rev_core (_bert_out_rev_kernel / _bert_out_rev_math), one Pallas
// program per (sample, layer), in the form without the MLP anchors (the JAX
// default). From att_ln, the cotangent g_out and the relevance R at the
// layer output out = LN2(dense2 + att_ln) it computes, in
// _bert_out_rev_math's order:
//   recompute: inter_pre = att_ln·Wiᵀ, inter_g = gelu(inter_pre + b_i),
//     dense2_nb = inter_g·Woᵀ (mlp mode), dense2 = dense2_nb + b_o
//   gradient: g_sum2 = LN2 backward of g_out; g_h1 = (g_sum2·Wo) ⊙
//     gelu′(inter_pre + b_i); g_attln = g_sum2 + g_h1·Wi (mlp mode)
//   relevance: the add rule over (dense2, att_ln) with per-sample sums; the
//     out and inter α-β rules (rule mode); the clone at att_ln -> R_att.
//
// What bounds it on the H100: it is block_rev.cu's MLP half, rearranged for
// post-norm (the LayerNorm sits above the residual add, and the clone
// merges at att_ln): the (S, I) intermediates and the weights do not fit in
// shared memory, so it is a sequence of launches over the whole batch on
// the GEMM core (gemm.cuh) with fused epilogues, the row kernel of the
// LayerNorm backward, and the two-pass add rule (rules.cuh), through one
// workspace. The recompute GEMMs repeat the forward's epilogues, so every
// anchor a rule divides by is bitwise the forward's value. Its ten bf16
// products (193 GFLOP at BERT-base B=8, S=512) bound it: 0.195 ms at the
// tensor cores' rate. On an H100 at 700 W the eight GEMM-core launches take
// 0.91 of the call's 0.99 ms; a third of theirs is the epilogues', which
// read and write the (B·S, I) intermediates in float32.
#include "rules.cuh"

namespace te {

int bert_out_rev(const float* att_ln, const float* g_out, const float* R,
                 const BlockWeights& w, float* g_attln, float* R_att,
                 char* work, size_t* work_bytes, int B, int n, int D, int I,
                 float eps, int mlp, int rule, cudaStream_t stream) {
  const int rows = B * n;
  const size_t rD = (size_t)rows * D, rI = (size_t)rows * I;
  Carve ws{work};
  float* inter_pre = ws.take<float>(rI);
  float* inter_g = ws.take<float>(rI);
  float* t_I = ws.take<float>(rI);       // g_h1, then the inter rule's S
  float* R1 = ws.take<float>(rI);        // the out rule's relevance
  float* dense2_nb = ws.take<float>(rD);
  float* z = ws.take<float>(rD);         // att_ln + dense2
  float* g_sum2 = ws.take<float>(rD);
  float* Ra = ws.take<float>(rD);        // add rule: the att_ln branch
  float* Rb = ws.take<float>(rD);        // add rule: the dense2 branch
  float* So = ws.take<float>(rD);        // the out rule's S
  float* partials = ws.take<float>((size_t)B * kAddChunks * 3);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }

  // recompute, with the forward's epilogues; the MLP products through
  // gemm_mlp, as B7 runs them (bf16×3 summed a k-step at a time, fault C8)
  TE_TRY(gemm_mlp<true, false, false>(
      mlp, GemmArgs{att_ln, w.w1_hi, w.w1_lo, D, D, rows, I, D},
      EpiGelu{inter_pre, inter_g, w.b1, I}, stream));
  TE_TRY(gemm_mlp<true, false, false>(
      mlp, GemmArgs{inter_g, w.w2_hi, w.w2_lo, I, I, rows, D, I},
      EpiResidual{dense2_nb, z, att_ln, w.b2, D}, stream));

  // gradient
  TE_TRY(ln_bwd(g_out, z, w.ln2s, nullptr, g_sum2, rows, D, eps, stream));
  TE_TRY(gemm_mlp<false, false, false>(
      mlp, GemmArgs{g_sum2, w.w2_hi, w.w2_lo, D, I, rows, I, D},
      EpiGeluGrad{t_I, inter_g, inter_pre, w.b1, I}, stream));
  TE_TRY(gemm_mlp<false, false, false>(
      mlp, GemmArgs{t_I, w.w1_hi, w.w1_lo, I, D, rows, D, I},
      EpiAdd{g_attln, g_sum2, D}, stream));

  // relevance: add split, out rule, inter rule with the clone at att_ln
  TE_TRY(add_rule(att_ln, dense2_nb, w.b2, R, partials, Ra, Rb, B, n, D,
                  stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{inter_g, w.w2_ahi, w.w2_alo, I, I, rows, D, I},
      EpiRuleDen{So, Rb, dense2_nb, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{So, w.w2_hi, w.w2_lo, D, I, rows, I, D, w.w2_ahi,
                     w.w2_alo},
      EpiRuleNum{R1, inter_g, I}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{att_ln, w.w1_ahi, w.w1_alo, D, D, rows, I, D},
      EpiRuleDen{t_I, R1, inter_pre, I}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{t_I, w.w1_hi, w.w1_lo, I, D, rows, D, I, w.w1_ahi,
                     w.w1_alo},
      EpiRuleClone{R_att, att_ln, Ra, att_ln, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: att_ln, g_out, R; the layer's
// vectors attn_ln scale, bias, out_ln scale, bias, b_qkv, b_ao, b_i, b_o;
// the weight planes (hi, lo) of qkv, attention output, inter, out (lo may
// be null for one-pass modes; this kernel reads inter and out), then the
// same of |W| (precision.PreparedWeight.abs); the outputs g_attln, R_att;
// the workspace (null: only write its size to *work_bytes). Modes: mlp
// (the four inter/out products) and rule (the rule GEMMs) 0 = bf16,
// 1 = bf16×3.
extern "C" int te_bert_out_rev_f32(
    const void* att_ln, const void* g_out, const void* R, const void* ln1s,
    const void* ln1b, const void* ln2s, const void* ln2b, const void* bqkv,
    const void* bao, const void* bi, const void* bo, const void* wqkv_hi,
    const void* wqkv_lo, const void* wao_hi, const void* wao_lo,
    const void* wi_hi, const void* wi_lo, const void* wo_hi,
    const void* wo_lo, const void* wqkv_ahi, const void* wqkv_alo,
    const void* wao_ahi, const void* wao_alo, const void* wi_ahi,
    const void* wi_alo, const void* wo_ahi, const void* wo_alo, void* g_attln, void* R_att, void* work,
    void* work_bytes, int B, int n, int D, int I, double eps, int mlp,
    int rule, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{
      static_cast<F>(ln1s), static_cast<F>(ln1b), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(bqkv), static_cast<F>(bao),
      static_cast<F>(bi), static_cast<F>(bo), static_cast<W>(wqkv_hi),
      static_cast<W>(wqkv_lo), static_cast<W>(wao_hi), static_cast<W>(wao_lo),
      static_cast<W>(wi_hi), static_cast<W>(wi_lo), static_cast<W>(wo_hi),
      static_cast<W>(wo_lo)};
  te::set_abs_planes(w, {wqkv_ahi, wqkv_alo, wao_ahi, wao_alo, wi_ahi, wi_alo,
                         wo_ahi, wo_alo});
  return te::bert_out_rev(
      static_cast<F>(att_ln), static_cast<F>(g_out), static_cast<F>(R), w,
      static_cast<float*>(g_attln), static_cast<float*>(R_att),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), B, n, D, I,
      (float)eps, mlp, rule, static_cast<cudaStream_t>(stream));
}
