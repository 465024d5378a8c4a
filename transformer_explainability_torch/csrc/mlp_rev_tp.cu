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
// each phase is a short sequence of launches over the whole batch through
// one workspace: a LayerNorm row kernel and the GEMM core (gemm.cuh, wgmma
// bf16 / bf16×3 on the tensor cores) with the elementwise work in the
// epilogues. Each phase is five products (2·B·n·D·M/k FLOP each, times the
// passes of its mode): operations-bound (0.04 ms a phase at ViT-B/16 B=8,
// k = 1 at the tensor cores' rate), and the (B·n, M/k) intermediates'
// round trips through device memory are as many bytes again. So in the
// presets' modes (every product one-pass bf16) each phase runs as few
// passes as its dependencies allow, on the core's fused passes:
//   phase 1: LN2 (xn2, and g_out rounded, as bf16); one pass of fc1 and
//     g_out·W2 on their common (rows, M/k) tile (two A operands, W1
//     K-major, W2 MN-major), whose epilogue forms fc1_pre, hg and g_h1 from
//     registers; then one grouped launch of fc2 with |hg|·|W2|ᵀ (one staged
//     hg, the second product on |hg|) and g_h1·W1, which fill the card
//     together;
//   phase 2: LN2 (xn2, and Sr rounded, as bf16); one pass of Sr·W2,
//     Sr·|W2| and |xn2|·|W1|ᵀ (three accumulator sets), whose epilogue
//     forms R2 and S1 at once (R2 never reaches device memory); then the
//     dual S1·W1 / S1·|W1|.
// xn2, g_out, Sr, hg, g_h1 and S1 are read only as one-pass bf16 A operands
// there, so they are staged as bf16, rounded as the core rounds a float32
// A (half the bytes and a deeper ring, no split in the consumers'
// registers): every product is bitwise the separate launches'
// (mlp_rev_tp1/2 with fused = 0, which the bf16×3 modes run). fc1_pre is
// an output and stays float32.
// Every sum has a fixed order (no atomics): the outputs are bitwise
// repeatable.
#include "rules.cuh"

namespace te {

// phase 2's fc2 rule numerator with hg re-formed from the anchor:
// (hg ⊙ Sr·W2 + |hg| ⊙ Sr·|W2|) / 2, hg = gelu(fc1_pre + b1) as in
// EpiGeluGrad
__device__ __forceinline__ float rule_num_gelu(float pre, float b1, float a,
                                               float b) {
  const float hg = gelu(pre + b1);
  return 0.5f * (hg * a + fabsf(hg) * b);
}

struct EpiRuleNumGelu {
  float* out; const float* fc1_pre; const float* b1; int N;
  static constexpr bool kLong = true;
  struct In { float pre, b1; };
  __device__ In load(int r, int c) const {
    return {fc1_pre[(size_t)r * N + c], b1[c]};
  }
  __device__ void operator()(int r, int c, float a, float b,
                             const In& in) const {
    out[(size_t)r * N + c] = rule_num_gelu(in.pre, in.b1, a, b);
  }
};

// phase 1's first pass (a = xn2·W1ᵀ, b = g_out·W2): fc1_pre, and from h1 =
// fc1_pre + b1 as EpiGeluGrad forms them, g_h1 and hg as bf16
struct EpiFc1Grad {
  float* fc1_pre; uint16_t* g_h1; uint16_t* hg; const float* b1; int N;
  static constexpr bool kLong = true;
  struct In { float b1; };
  __device__ In load(int, int c) const { return {b1[c]}; }
  __device__ void operator()(int r, int c, float a, float b,
                             const In& in) const {
    const size_t o = (size_t)r * N + c;
    fc1_pre[o] = a;
    const float h = a + in.b1;
    g_h1[o] = f2bf(b * gelu_grad(h));
    hg[o] = f2bf(gelu(h));
  }
};

// phase 2's three-set pass (a = Sr·W2, b = Sr·|W2|, d = |xn2|·|W1|ᵀ): R2
// as EpiRuleNumGelu forms it, S1 = safe_divide(R2, (fc1_pre + d) / 2) as
// EpiRuleDen, stored as bf16
struct EpiRuleS1 {
  uint16_t* S1; const float* fc1_pre; const float* b1; int N;
  static constexpr bool kLong = true;
  struct In { float pre, b1; };
  __device__ In load(int r, int c) const {
    return {fc1_pre[(size_t)r * N + c], b1[c]};
  }
  __device__ void operator()(int r, int c, float a, float b, float d,
                             const In& in) const {
    const float R2 = rule_num_gelu(in.pre, in.b1, a, b);
    S1[(size_t)r * N + c] = f2bf(safe_divide(R2, 0.5f * (in.pre + d)));
  }
};

int mlp_rev_tp1(const float* x_mid, const float* g_out, const float* ln2s,
                const float* ln2b, const float* b1, const uint16_t* w1_hi,
                const uint16_t* w1_lo, const uint16_t* w2_hi,
                const uint16_t* w2_lo, const uint16_t* w2_ahi,
                const uint16_t* w2_alo, float* fc1_pre, float* fc2_pre,
                float* axw2, float* gxn2, char* work, size_t* work_bytes,
                int rows, int D, int Ml, float eps, int mlp, int rule,
                int fused, cudaStream_t stream) {
  Carve ws{work};
  if (fused && mlp == kBf16 && rule == kBf16) {
    uint16_t* xn2 = ws.take<uint16_t>((size_t)rows * D);
    uint16_t* g16 = ws.take<uint16_t>((size_t)rows * D);
    uint16_t* g_h1 = ws.take<uint16_t>((size_t)rows * Ml);
    uint16_t* hg = ws.take<uint16_t>((size_t)rows * Ml);
    if (work == nullptr) {
      *work_bytes = ws.used;
      return 0;
    }
    if (D % 8 || Ml % 8) return (int)cudaErrorInvalidValue;
    TE_TRY(ln_fwd(x_mid, ln2s, ln2b, xn2, rows, D, eps, stream, g_out, g16));
    GemmItem<FusedTile<SpecTwoA>, EpiFc1Grad> p1;
    TE_TRY(gemm_item(p1, EpiFc1Grad{fc1_pre, g_h1, hg, b1, Ml}, rows, Ml, D,
                     {xn2, g16}, {D, D}, {w1_hi, w2_hi, nullptr, nullptr},
                     {D, Ml, 0, 0}));
    TE_TRY(gemm_run(p1, stream));
    using Fc2 = SpecDualAbsA;
    using Gxn2 = SpecStd<kBf16, false, false, false, true>;
    GemmItem<FusedTile<Fc2>, EpiStore2> p2;
    GemmItem<FusedTile<Gxn2>, EpiStore> p3;
    TE_TRY(gemm_item(p2, EpiStore2{fc2_pre, axw2, D}, rows, D, Ml,
                     {hg, nullptr}, {Ml, 0},
                     {w2_hi, w2_ahi, nullptr, nullptr}, {Ml, Ml, 0, 0}));
    TE_TRY(gemm_item(p3, EpiStore{gxn2, D}, rows, D, Ml, {g_h1, nullptr},
                     {Ml, 0}, {w1_hi, nullptr, nullptr, nullptr},
                     {D, 0, 0, 0}));
    return gemm_run(p2, stream, p3);
  }
  float* xn2 = ws.take<float>((size_t)rows * D);
  float* g_h1 = ws.take<float>((size_t)rows * Ml);
  float* hg = ws.take<float>((size_t)rows * Ml);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  // the separate launches (bf16×3 MLP products, or fused = 0): the MLP
  // products through gemm_mlp (bf16×3 summed a k-step at a time, fault C8)
  TE_TRY(ln_fwd(x_mid, ln2s, ln2b, xn2, rows, D, eps, stream));
  TE_TRY(gemm_mlp<true, false, false>(
      mlp, GemmArgs{xn2, w1_hi, w1_lo, D, D, rows, Ml, D},
      EpiStore{fc1_pre, Ml}, stream));
  TE_TRY(gemm_mlp<false, false, false>(
      mlp, GemmArgs{g_out, w2_hi, w2_lo, D, Ml, rows, Ml, D},
      EpiGeluGrad{g_h1, hg, fc1_pre, b1, Ml}, stream));
  TE_TRY(gemm_mlp<true, false, false>(
      mlp, GemmArgs{hg, w2_hi, w2_lo, Ml, Ml, rows, D, Ml},
      EpiStore{fc2_pre, D}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{hg, w2_ahi, w2_alo, Ml, Ml, rows, D, Ml},
      EpiStore{axw2, D}, stream));
  TE_TRY(gemm_mlp<false, false, false>(
      mlp, GemmArgs{g_h1, w1_hi, w1_lo, Ml, D, rows, D, Ml},
      EpiStore{gxn2, D}, stream));
  return 0;
}

int mlp_rev_tp2(const float* x_mid, const float* Sr, const float* fc1_pre,
                const float* ln2s, const float* ln2b, const float* b1,
                const uint16_t* w1_hi, const uint16_t* w1_lo,
                const uint16_t* w2_hi, const uint16_t* w2_lo,
                const uint16_t* w1_ahi, const uint16_t* w1_alo,
                const uint16_t* w2_ahi, const uint16_t* w2_alo, float* num_w,
                float* num_a, char* work, size_t* work_bytes, int rows, int D,
                int Ml, float eps, int rule, int fused,
                cudaStream_t stream) {
  Carve ws{work};
  if (fused && rule == kBf16) {
    uint16_t* xn2 = ws.take<uint16_t>((size_t)rows * D);
    uint16_t* Sr16 = ws.take<uint16_t>((size_t)rows * D);
    uint16_t* S1 = ws.take<uint16_t>((size_t)rows * Ml);
    if (work == nullptr) {
      *work_bytes = ws.used;
      return 0;
    }
    if (D % 8 || Ml % 8) return (int)cudaErrorInvalidValue;
    TE_TRY(ln_fwd(x_mid, ln2s, ln2b, xn2, rows, D, eps, stream, Sr, Sr16));
    GemmItem<FusedTile<SpecThree>, EpiRuleS1> p1;
    TE_TRY(gemm_item(p1, EpiRuleS1{S1, fc1_pre, b1, Ml}, rows, Ml, D,
                     {Sr16, xn2}, {D, D}, {w2_hi, w2_ahi, w1_ahi, nullptr},
                     {Ml, Ml, D, 0}));
    TE_TRY(gemm_run(p1, stream));
    GemmArgs g{nullptr, w1_hi, nullptr, 0, D, rows, D, Ml, w1_ahi, nullptr};
    g.A16 = S1;
    g.lda = Ml;
    return gemm16<false, false, true>(g, EpiStore2{num_w, num_a, D}, stream);
  }
  float* xn2 = ws.take<float>((size_t)rows * D);
  float* R2 = ws.take<float>((size_t)rows * Ml);
  float* S1 = ws.take<float>((size_t)rows * Ml);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  TE_TRY(ln_fwd(x_mid, ln2s, ln2b, xn2, rows, D, eps, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sr, w2_hi, w2_lo, D, Ml, rows, Ml, D, w2_ahi, w2_alo},
      EpiRuleNumGelu{R2, fc1_pre, b1, Ml}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{xn2, w1_ahi, w1_alo, D, D, rows, Ml, D},
      EpiRuleDen{S1, R2, fc1_pre, Ml}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{S1, w1_hi, w1_lo, Ml, D, rows, D, Ml, w1_ahi, w1_alo},
      EpiStore2{num_w, num_a, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry points (float32). Rows are the B·n tokens; D the embedding
// width, Ml this shard's MLP width M/k. The workspace comes last before the
// sizes (null: only write its size to *work_bytes). Modes: mlp (the
// forward, backward and fc2 products) and rule (the rule products) 0 = bf16,
// 1 = bf16×3. fused: 1 the fused passes where every product of the phase is
// one-pass bf16, 0 the separate launches (the checks hold the two bitwise
// equal).
// phase 1 pointers: x_mid, g_out, ln2s, ln2b, b1, the (hi, lo) planes of W1,
// W2 and |W2|; outputs fc1_pre, fc2_pre, axw2, g_xn2.
extern "C" int te_mlp_rev_tp1_f32(
    const void* x_mid, const void* g_out, const void* ln2s, const void* ln2b,
    const void* b1, const void* w1_hi, const void* w1_lo, const void* w2_hi,
    const void* w2_lo, const void* w2_ahi, const void* w2_alo, void* fc1_pre, void* fc2_pre, void* axw2, void* gxn2,
    void* work, void* work_bytes, int rows, int D, int Ml, double eps,
    int mlp, int rule, int fused, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  return te::mlp_rev_tp1(
      static_cast<F>(x_mid), static_cast<F>(g_out), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(b1), static_cast<W>(w1_hi),
      static_cast<W>(w1_lo), static_cast<W>(w2_hi), static_cast<W>(w2_lo),
      static_cast<W>(w2_ahi), static_cast<W>(w2_alo),
      static_cast<float*>(fc1_pre), static_cast<float*>(fc2_pre),
      static_cast<float*>(axw2), static_cast<float*>(gxn2),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), rows, D,
      Ml, (float)eps, mlp, rule, fused, static_cast<cudaStream_t>(stream));
}

// phase 2 pointers: x_mid, Sr, fc1_pre (phase 1's anchor), ln2s, ln2b, b1,
// the (hi, lo) planes of W1 and W2 and of |W1| and |W2|; outputs num_w,
// num_a.
extern "C" int te_mlp_rev_tp2_f32(
    const void* x_mid, const void* Sr, const void* fc1_pre, const void* ln2s,
    const void* ln2b, const void* b1, const void* w1_hi, const void* w1_lo,
    const void* w2_hi, const void* w2_lo, const void* w1_ahi,
    const void* w1_alo, const void* w2_ahi, const void* w2_alo, void* num_w,
    void* num_a, void* work, void* work_bytes, int rows, int D, int Ml,
    double eps, int rule, int fused, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  return te::mlp_rev_tp2(
      static_cast<F>(x_mid), static_cast<F>(Sr), static_cast<F>(fc1_pre),
      static_cast<F>(ln2s), static_cast<F>(ln2b), static_cast<F>(b1),
      static_cast<W>(w1_hi), static_cast<W>(w1_lo), static_cast<W>(w2_hi),
      static_cast<W>(w2_lo), static_cast<W>(w1_ahi), static_cast<W>(w1_alo),
      static_cast<W>(w2_ahi), static_cast<W>(w2_alo),
      static_cast<float*>(num_w), static_cast<float*>(num_a),
      static_cast<char*>(work),
      static_cast<size_t*>(work_bytes), rows, D, Ml, (float)eps, rule, fused,
      static_cast<cudaStream_t>(stream));
}
