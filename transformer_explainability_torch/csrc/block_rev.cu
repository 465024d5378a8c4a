// block_rev_core: the whole fused reverse step of one ViT block.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// block_rev_core (_block_rev_kernel / _block_rev_math), one Pallas program
// per (sample, block), in the form with the six saved anchors (qkv_pre,
// proj_pre, dots, probs, fc1_pre, fc2_pre from block_fwd.cu). From the
// cotangent g_out and the relevance R at the block output it computes, in
// _block_rev_math's order:
//   MLP half (_mlp_rev_math): LN2 recompute; g_h1 = (g_out·W2) ⊙ gelu′(h1),
//     g_xn2 = g_h1·W1 (mlp mode), LN2 backward -> g_mid; the add2 rule
//     (per-sample sums); the fc2 and fc1 α-β rules (rule mode); the clone
//     -> Rm
//   g_om = g_mid·Wproj (mxu); the add1 rule with Z = x_in + (proj_pre +
//     bproj) recomputed, not the saved x_mid; the proj rule -> cam_o
//   the attention reverse (_attn_rev_math) from the saved probs, dots and
//     out_m: gradient products in attn mode, rule products in rule mode,
//     gc = mean_h (g_attn ⊙ cam1)⁺
//   g_xn1 = g_qkv·Wqkv (mxu), LN1 backward -> g_in; the qkv rule and the
//     clone -> R_in.
//
// What bounds it on the H100: as block_fwd.cu, the weights and the (n, M)
// intermediates do not fit in shared memory, so the step is a sequence of
// launches over the whole batch: the products in the GEMM core (gemm.cuh,
// tensor cores; each α-β rule is one |x|·|W|ᵀ GEMM with the safe-divide in
// its epilogue and one dual GEMM S·W, S·|W| with the rule's combination,
// and the clone, in its epilogue), row kernels for the LayerNorms, two
// passes per add rule (per-chunk partial sums, then every block sums the
// sample's partials in the same fixed order: deterministic, no atomics),
// and the attention reverse as the row / column / head-mean passes of
// attn_rev.cu without the forward recompute. Intermediates go through one
// workspace in device memory. The rule epilogues, the add rule and the
// column and head-mean passes live in rules.cuh, shared with the BERT
// reverse kernels; the MLP half in mlp_rev.cuh, shared with mlp_rev.cu.
#include "mlp_rev.cuh"

namespace te {

// ---------------------------------------------------------------------------
// Attention reverse from the saved anchors (_attn_rev_math with saved_attn
// and out_m). RA: gradient products in bf16 (else float32); RR: rule
// products in bf16 (else float32). q, k, v = qkv_pre + bqkv, formed with the
// forward's own add.
// ---------------------------------------------------------------------------

// rows: one block per (row tile, head, sample), K and V of the head in
// shared memory, one warp per query row. Emits g_q and cam_q, and writes
// g_dots (G), S2, the per-head (g_attn ⊙ cam1)⁺ (GCP) and S1 to scratch.
template <bool RA, bool RR>
__global__ void blk_attn_rev_rows_kernel(
    const float* __restrict__ qkv_pre, const float* __restrict__ bqkv,
    const float* __restrict__ probs, const float* __restrict__ dots,
    const float* __restrict__ out_m, const float* __restrict__ g_o,
    const float* __restrict__ cam_o, float* __restrict__ g_qkv,
    float* __restrict__ cam_qkv, float* __restrict__ G,
    float* __restrict__ S2g, float* __restrict__ GCP,
    float* __restrict__ S1g, int n, int H, int hd, float scale,
    int rows_per_block) {
  float* smem = reinterpret_cast<float*>(te_smem);
  const int ldk = hd + 1;
  float* Ks = smem;
  float* Vs = Ks + (size_t)n * ldk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* qw = Vs + (size_t)n * ldk + (size_t)warp * (3 * hd + 3 * n);
  float* gw = qw + hd;   // g_o row
  float* sw = gw + hd;   // S1 row
  float* ra = sw + hd;   // dots, then S2
  float* rb = ra + n;    // probs
  float* rc = rb + n;    // g_attn, then g_dots

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv_pre + (size_t)b * n * ld;
  const size_t nn = (size_t)n * n;
  const size_t bh = (size_t)b * H + h;

  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    Ks[j * ldk + d] = base[(size_t)j * ld + D + h * hd + d] + bqkv[D + h * hd + d];
    Vs[j * ldk + d] =
        base[(size_t)j * ld + 2 * D + h * hd + d] + bqkv[2 * D + h * hd + d];
  }
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  for (int i = row0 + warp; i < row_end; i += nwarps) {
    const size_t row_md = ((size_t)b * n + i) * D + h * hd;
    const size_t row_q = ((size_t)b * n + i) * ld + h * hd;
    for (int d = lane; d < hd; d += kWarp) {
      qw[d] = qkv_pre[row_q + d] + bqkv[h * hd + d];
      gw[d] = g_o[row_md + d];
      const float s1 = safe_divide(cam_o[row_md + d], out_m[row_md + d]);
      sw[d] = s1;
      S1g[(bh * n + i) * hd + d] = s1;
    }
    for (int j = lane; j < n; j += kWarp) {
      ra[j] = dots[(bh * n + i) * n + j];
      rb[j] = probs[(bh * n + i) * n + j];
    }
    __syncwarp();

    // hook gradient, AV z-rule, QKᵀ denominator, (grad ⊙ cam)⁺
    float inner = 0.f;
    for (int j = lane; j < n; j += kWarp) {
      const float* vr = Vs + j * ldk;
      float ga = 0.f, t = 0.f;
      for (int d = 0; d < hd; ++d) {
        ga = fmaf(rnd<RA>(gw[d]), rnd<RA>(vr[d]), ga);
        t = fmaf(rnd<RR>(sw[d]), rnd<RR>(vr[d]), t);
      }
      const float a = rb[j];
      inner = fmaf(ga, a, inner);
      const float cam1 = a * t * 0.5f;
      ra[j] = safe_divide(cam1, ra[j]);
      rc[j] = ga;
      const float gcv = ga * cam1;
      GCP[bh * nn + (size_t)i * n + j] = gcv > 0.f ? gcv : 0.f;
    }
    inner = warp_sum(inner);
    for (int j = lane; j < n; j += kWarp) {
      const float gd = rb[j] * (rc[j] - inner) * scale;
      rc[j] = gd;
      const size_t o = bh * nn + (size_t)i * n + j;
      G[o] = gd;
      S2g[o] = ra[j];
    }
    __syncwarp();

    // g_q = g_dots K, cam_q = q ⊙ (S2 K) / 2
    for (int d = lane; d < hd; d += kWarp) {
      float gq = 0.f, cq = 0.f;
      for (int j = 0; j < n; ++j) {
        const float kv = Ks[j * ldk + d];
        gq = fmaf(rnd<RA>(rc[j]), rnd<RA>(kv), gq);
        cq = fmaf(rnd<RR>(ra[j]), rnd<RR>(kv), cq);
      }
      g_qkv[row_q + d] = gq;
      cam_qkv[row_q + d] = qw[d] * cq * 0.5f;
    }
    __syncwarp();  // the next row overwrites the warp's buffers
  }
}

template <bool RA, bool RR>
int blk_attn_rev(const float* qkv_pre, const float* bqkv, const float* probs,
                 const float* dots, const float* out_m, const float* g_o,
                 const float* cam_o, float* g_qkv, float* cam_qkv, float* gc,
                 float* G, float* S2, float* GCP, float* S1, int B, int n,
                 int H, int hd, float scale, cudaStream_t stream) {
  const int limit = max_smem_optin();
  int warps = 8;
  size_t smem_rows = 0;
  for (; warps >= 1; warps /= 2) {
    smem_rows = sizeof(float) * ((size_t)2 * n * (hd + 1) +
                                 (size_t)warps * (3 * hd + 3 * n));
    if (smem_rows <= (size_t)limit) break;
  }
  if (warps < 1) return (int)cudaErrorInvalidValue;
  auto rows_kern = blk_attn_rev_rows_kernel<RA, RR>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  const int rows = 4 * warps;
  dim3 grid_rows((n + rows - 1) / rows, H, B);
  TE_LAUNCH(rows_kern, grid_rows, warps * kWarp, smem_rows, stream)(
      qkv_pre, bqkv, probs, dots, out_m, g_o, cam_o, g_qkv, cam_qkv, G, S2,
      GCP, S1, n, H, hd, scale, rows);
  TE_TRY((int)cudaGetLastError());
  return attn_rev_cols<RA, RR>(qkv_pre, bqkv, g_o, probs, G, S2, S1, GCP,
                               g_qkv, cam_qkv, gc, B, n, H, hd, stream);
}

struct Saved {
  const float *qkv_pre, *proj_pre, *dots, *probs, *fc1_pre, *fc2_pre;
};

int block_rev(const float* x_in, const float* x_mid, const float* out_m,
              const float* g_out, const float* R, const Saved& sv,
              const BlockWeights& w, float* g_in, float* R_in, float* gc,
              char* work, size_t* work_bytes, int B, int n, int H, int hd,
              int M, float eps, int mxu, int attn_bf16, int rule_bf16,
              int rule, int mlp, cudaStream_t stream) {
  if (hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const int D = H * hd, rows = B * n;
  const size_t rD = (size_t)rows * D;
  const size_t hnn = (size_t)B * H * n * n;
  Carve ws{work};
  float* xn1 = ws.take<float>(rD);
  float* xn2 = ws.take<float>(rD);
  const MlpRevWork mw(ws, B, rows, D, M);
  float* t_D = mw.t_D;                  // g_xn2, then g_xn1
  float* g_mid = ws.take<float>(rD);
  float* Rm = ws.take<float>(rD);
  float* g_om = ws.take<float>(rD);
  float* Ra1 = ws.take<float>(rD);
  float* Ra2 = ws.take<float>(rD);
  float* Sp = ws.take<float>(rD);
  float* cam_o = ws.take<float>(rD);
  float* g_qkv = ws.take<float>(3 * rD);
  float* cam_qkv = ws.take<float>(3 * rD);
  float* Sq = ws.take<float>(3 * rD);
  float* G = ws.take<float>(hnn);
  float* S2 = ws.take<float>(hnn);
  float* GCP = ws.take<float>(hnn);
  float* S1 = ws.take<float>((size_t)B * H * n * hd);
  float* partials = mw.partials;
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const float scale = (float)pow((double)hd, -0.5);   // as hd ** -0.5
  const uint16_t *q_hi = w.wqkv_hi, *q_lo = w.wqkv_lo;
  const uint16_t *p_hi = w.wproj_hi, *p_lo = w.wproj_lo;

  // MLP half (mlp_rev.cuh, shared with mlp_rev.cu)
  TE_TRY(ln_fwd(x_in, w.ln1s, w.ln1b, xn1, rows, D, eps, stream));
  TE_TRY(ln_fwd(x_mid, w.ln2s, w.ln2b, xn2, rows, D, eps, stream));
  TE_TRY(mlp_rev_half(x_mid, xn2, g_out, R, sv.fc1_pre, sv.fc2_pre, w, mw,
                      g_mid, Rm, B, n, D, M, eps, mlp, rule, stream));

  // add1 split and proj rule
  TE_TRY(gemm<false, false, false>(
      mxu, GemmArgs{g_mid, p_hi, p_lo, D, D, rows, D, D}, EpiStore{g_om, D},
      stream));
  TE_TRY(add_rule(x_in, sv.proj_pre, w.bproj, Rm, partials, Ra1, Ra2, B, n,
                  D, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{out_m, p_hi, p_lo, D, D, rows, D, D},
      EpiRuleDen{Sp, Ra2, sv.proj_pre, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sp, p_hi, p_lo, D, D, rows, D, D},
      EpiRuleNum{cam_o, out_m, D}, stream));

  // attention core
  const int ra = attn_bf16 ? 1 : 0, rr = rule_bf16 ? 1 : 0;
  const auto attn = ra ? (rr ? blk_attn_rev<true, true> : blk_attn_rev<true, false>)
                       : (rr ? blk_attn_rev<false, true> : blk_attn_rev<false, false>);
  TE_TRY(attn(sv.qkv_pre, w.bqkv, sv.probs, sv.dots, out_m, g_om, cam_o,
              g_qkv, cam_qkv, gc, G, S2, GCP, S1, B, n, H, hd, scale,
              stream));

  // qkv-side tails
  TE_TRY(gemm<false, false, false>(
      mxu, GemmArgs{g_qkv, q_hi, q_lo, 3 * D, D, rows, D, 3 * D},
      EpiStore{t_D, D}, stream));
  TE_TRY(ln_bwd(t_D, x_in, w.ln1s, g_mid, g_in, rows, D, eps, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{xn1, q_hi, q_lo, D, D, rows, 3 * D, D},
      EpiRuleDen{Sq, cam_qkv, sv.qkv_pre, 3 * D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sq, q_hi, q_lo, 3 * D, D, rows, D, 3 * D},
      EpiRuleClone{R_in, xn1, Ra1, x_in, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x_in, x_mid, out_m, g_out, R; the
// saved anchors qkv_pre, proj_pre, dots, probs, fc1_pre, fc2_pre; ln1s,
// ln1b, ln2s, ln2b, bqkv, bproj, b1, b2; the weight planes (hi, lo) of qkv,
// proj, fc1, fc2 (lo may be null for one-pass modes); the outputs g_in,
// R_in, gc; the workspace (null: only write its size to *work_bytes).
// Modes: mxu, rule (the rule GEMMs) and mlp 0 = bf16, 1 = bf16×3;
// attn_bf16 and rule_bf16 (the attention's gradient and rule products)
// 1 = bf16 operands, 0 = float32.
extern "C" int te_block_rev_f32(
    const void* x_in, const void* x_mid, const void* out_m, const void* g_out,
    const void* R, const void* qkv_pre, const void* proj_pre,
    const void* dots, const void* probs, const void* fc1_pre,
    const void* fc2_pre, const void* ln1s, const void* ln1b,
    const void* ln2s, const void* ln2b, const void* bqkv, const void* bproj,
    const void* b1, const void* b2, const void* wqkv_hi, const void* wqkv_lo,
    const void* wproj_hi, const void* wproj_lo, const void* w1_hi,
    const void* w1_lo, const void* w2_hi, const void* w2_lo, void* g_in,
    void* R_in, void* gc, void* work, void* work_bytes, int B, int n, int H,
    int hd, int M, double eps, int mxu, int attn_bf16, int rule_bf16,
    int rule, int mlp, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{
      static_cast<F>(ln1s), static_cast<F>(ln1b), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(bqkv), static_cast<F>(bproj),
      static_cast<F>(b1), static_cast<F>(b2), static_cast<W>(wqkv_hi),
      static_cast<W>(wqkv_lo), static_cast<W>(wproj_hi),
      static_cast<W>(wproj_lo), static_cast<W>(w1_hi), static_cast<W>(w1_lo),
      static_cast<W>(w2_hi), static_cast<W>(w2_lo)};
  te::Saved sv{static_cast<F>(qkv_pre), static_cast<F>(proj_pre),
               static_cast<F>(dots), static_cast<F>(probs),
               static_cast<F>(fc1_pre), static_cast<F>(fc2_pre)};
  return te::block_rev(
      static_cast<F>(x_in), static_cast<F>(x_mid), static_cast<F>(out_m),
      static_cast<F>(g_out), static_cast<F>(R), sv, w,
      static_cast<float*>(g_in), static_cast<float*>(R_in),
      static_cast<float*>(gc), static_cast<char*>(work),
      static_cast<size_t*>(work_bytes), B, n, H, hd, M, (float)eps, mxu,
      attn_bf16, rule_bf16, rule, mlp, static_cast<cudaStream_t>(stream));
}
