// mlp_rev_tp_phase1 / mlp_rev_tp_phase2: the MLP half of the ViT reverse
// step under tensor parallelism, split where the collectives fall.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// mlp_rev_tp_phase1 (_mlp_rev_tp1_kernel) and mlp_rev_tp_phase2
// (_mlp_rev_tp2_kernel), one Pallas program per sample with this shard's W1
// and W2 and every (n, M/k) tensor in VMEM. Under tensor parallelism fc1 is
// column-parallel and fc2 row-parallel, so the MLP half factors into two
// local phases around all-reduces of (B, n, D) partials
// (parallel/tensor.py):
//   phase 1: xn2 = LN2(x_mid); fc1_pre = xn2·W1ᵀ (mlp);
//     g_h1 = (g_out·W2) ⊙ gelu′(h1) and hg = gelu(h1), h1 = fc1_pre + b1
//     (mlp); fc2_pre = hg·W2ᵀ (mlp); axw2 = |hg|·|W2|ᵀ (rule);
//     g_xn2 = g_h1·W1 (mlp). Out: the anchor fc1_pre (B, n, M/k) and the
//     partials fc2_pre, axw2, g_xn2 (B, n, D).
//   phase 2: hg re-formed from phase 1's fc1_pre by the same epilogue
//     expression; R2 = (hg ⊙ Sr·W2 + |hg| ⊙ Sr·|W2|) / 2 (rule, one dual
//     GEMM); S1 = safe_divide(R2, (fc1_pre + |xn2|·|W1|ᵀ) / 2) (rule);
//     num_w = S1·W1, num_a = S1·|W1| (rule, one dual GEMM). Out: the
//     partials num_w, num_a (B, n, D), merged by the caller after the
//     all-reduce. Sr is the fc2 rule's divide, formed by the caller from the
//     all-reduced fc2_pre and axw2.
// Weights are this shard's nn.Linear slices, W1 (M/k, D) and W2 (D, M/k),
// as bf16 (hi, lo) planes (lo null for one-pass modes). Biases are added
// apart from the products, as in the forward kernels' epilogues.
//
// What bounds it on the H100: as in block_rev.cu's MLP half, the shard's
// weights and the (B·n, M/k) intermediates do not fit in shared memory, so
// each phase is a sequence of launches over the whole batch through one
// workspace: a LayerNorm row kernel and the GEMM core (gemm.cuh, mma.sync
// bf16 / bf16×3 on the tensor cores) with the elementwise work in the
// epilogues. Each phase is five products (2·B·n·D·M/k FLOP each, times the
// passes of its mode) and is bound by the GEMM core's rate (≈ 80 TFLOP/s of
// bf16 passes in PR 2's measurements), far from the tensor cores' peak.
// Every sum has a fixed order (no atomics): the outputs are bitwise
// repeatable.
#include "rules.cuh"

namespace te {

// phase 2's fc2 rule numerator with hg re-formed from the anchor:
// (hg ⊙ Sr·W2 + |hg| ⊙ Sr·|W2|) / 2, hg = gelu(fc1_pre + b1) as in
// EpiGeluGrad
struct EpiRuleNumGelu {
  float* out; const float* fc1_pre; const float* b1; int N;
  __device__ void operator()(int r, int c, float a, float b) const {
    const size_t o = (size_t)r * N + c;
    const float h = fc1_pre[o] + b1[c];
    const float hg = gelu(h);
    out[o] = 0.5f * (hg * a + fabsf(hg) * b);
  }
};

// both products of a dual GEMM, stored apart (A·W and A·|W|)
struct EpiStore2 {
  float* C; float* Cabs; int N;
  __device__ void operator()(int r, int c, float a, float b) const {
    const size_t o = (size_t)r * N + c;
    C[o] = a;
    Cabs[o] = b;
  }
};

int mlp_rev_tp1(const float* x_mid, const float* g_out, const float* ln2s,
                const float* ln2b, const float* b1, const uint16_t* w1_hi,
                const uint16_t* w1_lo, const uint16_t* w2_hi,
                const uint16_t* w2_lo, float* fc1_pre, float* fc2_pre,
                float* axw2, float* gxn2, char* work, size_t* work_bytes,
                int rows, int D, int Ml, float eps, int mlp, int rule,
                cudaStream_t stream) {
  Carve ws{work};
  float* xn2 = ws.take<float>((size_t)rows * D);
  float* g_h1 = ws.take<float>((size_t)rows * Ml);
  float* hg = ws.take<float>((size_t)rows * Ml);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  TE_TRY(ln_fwd(x_mid, ln2s, ln2b, xn2, rows, D, eps, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{xn2, w1_hi, w1_lo, D, D, rows, Ml, D},
      EpiStore{fc1_pre, Ml}, stream));
  TE_TRY(gemm<false, false, false>(
      mlp, GemmArgs{g_out, w2_hi, w2_lo, D, Ml, rows, Ml, D},
      EpiGeluGrad{g_h1, hg, fc1_pre, b1, Ml}, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{hg, w2_hi, w2_lo, Ml, Ml, rows, D, Ml},
      EpiStore{fc2_pre, D}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{hg, w2_hi, w2_lo, Ml, Ml, rows, D, Ml},
      EpiStore{axw2, D}, stream));
  TE_TRY(gemm<false, false, false>(
      mlp, GemmArgs{g_h1, w1_hi, w1_lo, Ml, D, rows, D, Ml},
      EpiStore{gxn2, D}, stream));
  return 0;
}

int mlp_rev_tp2(const float* x_mid, const float* Sr, const float* fc1_pre,
                const float* ln2s, const float* ln2b, const float* b1,
                const uint16_t* w1_hi, const uint16_t* w1_lo,
                const uint16_t* w2_hi, const uint16_t* w2_lo, float* num_w,
                float* num_a, char* work, size_t* work_bytes, int rows, int D,
                int Ml, float eps, int rule, cudaStream_t stream) {
  Carve ws{work};
  float* xn2 = ws.take<float>((size_t)rows * D);
  float* R2 = ws.take<float>((size_t)rows * Ml);
  float* S1 = ws.take<float>((size_t)rows * Ml);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  TE_TRY(ln_fwd(x_mid, ln2s, ln2b, xn2, rows, D, eps, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sr, w2_hi, w2_lo, D, Ml, rows, Ml, D},
      EpiRuleNumGelu{R2, fc1_pre, b1, Ml}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{xn2, w1_hi, w1_lo, D, D, rows, Ml, D},
      EpiRuleDen{S1, R2, fc1_pre, Ml}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{S1, w1_hi, w1_lo, Ml, D, rows, D, Ml},
      EpiStore2{num_w, num_a, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry points (float32). Rows are the B·n tokens; D the embedding
// width, Ml this shard's MLP width M/k. The workspace comes last before the
// sizes (null: only write its size to *work_bytes). Modes: mlp (the
// forward, backward and fc2 products) and rule (the rule products) 0 = bf16,
// 1 = bf16×3.
// phase 1 pointers: x_mid, g_out, ln2s, ln2b, b1, the (hi, lo) planes of W1
// and W2; outputs fc1_pre, fc2_pre, axw2, g_xn2.
extern "C" int te_mlp_rev_tp1_f32(
    const void* x_mid, const void* g_out, const void* ln2s, const void* ln2b,
    const void* b1, const void* w1_hi, const void* w1_lo, const void* w2_hi,
    const void* w2_lo, void* fc1_pre, void* fc2_pre, void* axw2, void* gxn2,
    void* work, void* work_bytes, int rows, int D, int Ml, double eps,
    int mlp, int rule, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  return te::mlp_rev_tp1(
      static_cast<F>(x_mid), static_cast<F>(g_out), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(b1), static_cast<W>(w1_hi),
      static_cast<W>(w1_lo), static_cast<W>(w2_hi), static_cast<W>(w2_lo),
      static_cast<float*>(fc1_pre), static_cast<float*>(fc2_pre),
      static_cast<float*>(axw2), static_cast<float*>(gxn2),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), rows, D,
      Ml, (float)eps, mlp, rule, static_cast<cudaStream_t>(stream));
}

// phase 2 pointers: x_mid, Sr, fc1_pre (phase 1's anchor), ln2s, ln2b, b1,
// the (hi, lo) planes of W1 and W2; outputs num_w, num_a.
extern "C" int te_mlp_rev_tp2_f32(
    const void* x_mid, const void* Sr, const void* fc1_pre, const void* ln2s,
    const void* ln2b, const void* b1, const void* w1_hi, const void* w1_lo,
    const void* w2_hi, const void* w2_lo, void* num_w, void* num_a,
    void* work, void* work_bytes, int rows, int D, int Ml, double eps,
    int rule, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  return te::mlp_rev_tp2(
      static_cast<F>(x_mid), static_cast<F>(Sr), static_cast<F>(fc1_pre),
      static_cast<F>(ln2s), static_cast<F>(ln2b), static_cast<F>(b1),
      static_cast<W>(w1_hi), static_cast<W>(w1_lo), static_cast<W>(w2_hi),
      static_cast<W>(w2_lo), static_cast<float*>(num_w),
      static_cast<float*>(num_a), static_cast<char*>(work),
      static_cast<size_t*>(work_bytes), rows, D, Ml, (float)eps, rule,
      static_cast<cudaStream_t>(stream));
}
