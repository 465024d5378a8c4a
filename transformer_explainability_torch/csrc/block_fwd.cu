// block_fwd_core: one whole ViT block forward, with the rich anchors.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// block_fwd_core (_block_fwd_kernel / _block_fwd_math), which runs a block
// per (sample, block) in one Pallas program with all weights in VMEM:
//   xn1 = LN1(x); qkv_pre = xn1·Wqkvᵀ (mxu); qkv = qkv_pre + bqkv
//   per head: dots = q·kᵀ (attn_mxu, pre-scale), probs = softmax(dots·scale),
//             out_m = probs·v (attn_mxu)
//   proj_pre = out_m·Wprojᵀ (mxu); x_mid = x + (proj_pre + bproj)
//   xn2 = LN2(x_mid); fc1_pre = xn2·W1ᵀ (mlp); hg = gelu(fc1_pre + b1)
//   fc2_pre = hg·W2ᵀ (mlp); x_out = x_mid + (fc2_pre + b2)
// and saves x_mid, out_m and the rich anchors qkv_pre, proj_pre, dots,
// probs (B, h·n, n), fc1_pre, fc2_pre for block_rev_core.
//
// What bounds it on the H100: one sample's weights (14 MB as bf16 pairs) do
// not fit in a block's 227 KB of shared memory, and the (n, M) GELU
// activations do not either. So the block is split into launches over the
// whole batch (B·n rows share each weight read): LN1, the qkv GEMM, the
// attention core per (row tile, head, sample), the proj GEMM, LN2, the fc1
// GEMM with GELU in its epilogue, the fc2 GEMM; intermediates go through a
// workspace in device memory (mostly L2-resident at B=8). The four GEMMs
// (gemm.cuh) run on the tensor cores. The attention core is B4's kernel
// (attn_fwd.cuh: 64-row query tiles, 8 × 8 register tiles for the scores
// and P·V, the softmax in registers up to 256 keys; FP32 off the tensor
// cores, the operands rounded to bf16 when attn_mxu is bfloat16, three
// passes over their bf16×3 parts when it is tensorfloat32) in an
// instance that also stores, from its register tiles, the pre-scale dots
// and the probabilities before any rounding, and sums P·V in one chain per
// output: the operation order of the per-row core it replaced, so dots,
// probs and out_m are that core's.
#include "attn_fwd.cuh"
#include "gemm.cuh"

namespace te {

int block_fwd(const float* x, const BlockWeights& w, float* x_out,
              float* x_mid, float* out_m, float* qkv_pre, float* proj_pre,
              float* dots, float* probs, float* fc1_pre, float* fc2_pre,
              char* work, size_t* work_bytes, int B, int n, int H, int hd,
              int M, float eps, int mxu, int attn_mode, int mlp,
              cudaStream_t stream) {
  if (attn_mode < kModeF32 || attn_mode > kModeBf16x3)
    return (int)cudaErrorInvalidValue;
  const int D = H * hd, rows = B * n;
  Carve ws{work};
  float* xn = ws.take<float>((size_t)rows * D);
  float* qkv = ws.take<float>((size_t)rows * 3 * D);
  float* hg = ws.take<float>((size_t)rows * M);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const float scale = (float)pow((double)hd, -0.5);   // as hd ** -0.5

  TE_TRY(ln_fwd(x, w.ln1s, w.ln1b, xn, rows, D, eps, stream));
  TE_TRY(gemm<true, false, false>(
      mxu, GemmArgs{xn, w.wqkv_hi, w.wqkv_lo, D, D, rows, 3 * D, D},
      EpiQkv{qkv_pre, qkv, w.bqkv, 3 * D}, stream));
  const auto attn = attn_mode == kModeBf16x3
                        ? attn_fwd_launch<float, kModeBf16x3, true>
                    : attn_mode ? attn_fwd_launch<float, kModeBf16, true>
                                : attn_fwd_launch<float, kModeF32, true>;
  TE_TRY(attn(qkv, out_m, dots, probs, B, n, H, hd, scale, stream));
  TE_TRY(gemm<true, false, false>(
      mxu, GemmArgs{out_m, w.wproj_hi, w.wproj_lo, D, D, rows, D, D},
      EpiResidual{proj_pre, x_mid, x, w.bproj, D}, stream));
  TE_TRY(ln_fwd(x_mid, w.ln2s, w.ln2b, xn, rows, D, eps, stream));
  TE_TRY(gemm_mlp<true, false, false>(
      mlp, GemmArgs{xn, w.w1_hi, w.w1_lo, D, D, rows, M, D},
      EpiGelu{fc1_pre, hg, w.b1, M}, stream));
  TE_TRY(gemm_mlp<true, false, false>(
      mlp, GemmArgs{hg, w.w2_hi, w.w2_lo, M, M, rows, D, M},
      EpiResidual{fc2_pre, x_out, x_mid, w.b2, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x; ln1s, ln1b, ln2s, ln2b, bqkv,
// bproj, b1, b2; the weight planes (hi, lo) of qkv, proj, fc1, fc2 (lo may be
// null for one-pass modes); the outputs x_out, x_mid, out_m, qkv_pre,
// proj_pre, dots, probs, fc1_pre, fc2_pre; the workspace. With a null
// workspace it only writes the workspace size to *work_bytes. Modes: mxu and
// mlp 0 = bf16, 1 = bf16×3; attn_mode 0 = float32, 1 = bf16, 2 = bf16×3.
extern "C" int te_block_fwd_f32(
    const void* x, const void* ln1s, const void* ln1b, const void* ln2s,
    const void* ln2b, const void* bqkv, const void* bproj, const void* b1,
    const void* b2, const void* wqkv_hi, const void* wqkv_lo,
    const void* wproj_hi, const void* wproj_lo, const void* w1_hi,
    const void* w1_lo, const void* w2_hi, const void* w2_lo, void* x_out,
    void* x_mid, void* out_m, void* qkv_pre, void* proj_pre, void* dots,
    void* probs, void* fc1_pre, void* fc2_pre, void* work, void* work_bytes,
    int B, int n, int H, int hd, int M, double eps, int mxu, int attn_mode,
    int mlp, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{
      static_cast<F>(ln1s), static_cast<F>(ln1b), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(bqkv), static_cast<F>(bproj),
      static_cast<F>(b1), static_cast<F>(b2), static_cast<W>(wqkv_hi),
      static_cast<W>(wqkv_lo), static_cast<W>(wproj_hi),
      static_cast<W>(wproj_lo), static_cast<W>(w1_hi), static_cast<W>(w1_lo),
      static_cast<W>(w2_hi), static_cast<W>(w2_lo)};
  return te::block_fwd(
      static_cast<F>(x), w, static_cast<float*>(x_out),
      static_cast<float*>(x_mid), static_cast<float*>(out_m),
      static_cast<float*>(qkv_pre), static_cast<float*>(proj_pre),
      static_cast<float*>(dots), static_cast<float*>(probs),
      static_cast<float*>(fc1_pre), static_cast<float*>(fc2_pre),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), B, n, H, hd,
      M, (float)eps, mxu, attn_mode, mlp, static_cast<cudaStream_t>(stream));
}
