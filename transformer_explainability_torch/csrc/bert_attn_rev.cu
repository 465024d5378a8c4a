// bert_attn_rev_core: the reverse of a BERT layer's masked attention
// sub-block, with the head-mean (grad ⊙ cam)⁺ map fused in.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// bert_attn_rev_core, which on the TPU is one fused Pallas program per
// (sample, layer) up to S=384 (_bert_attn_rev_kernel) and a mid program
// plus 4-head chunk programs above (_bert_attn_mid_kernel,
// _bert_attn_chunk_kernel, _attn_rev_combine), in the form with the slim
// anchors (qkv_pre, ctx, dense_nb from bert_fwd.cu). From x_in, the
// cotangent g_attln and the relevance R_att at att_ln = LN1(dense_out +
// x_in) it computes, in _bert_attn_rev_math's order:
//   mid: att_mid = x_in + (dense_nb + b_ao); g_sum1 = LN1 backward of
//     g_attln; g_ctx = g_sum1·Wao (mxu); the add rule over (dense_out,
//     x_in) -> (R1, R2); the dense rule -> R1f (rule mode)
//   per head (_attn_head_rev): raw and the masked softmax recomputed
//     (bert_attn.cuh, bitwise the forward's); g_probs = g_o·vᵀ, the
//     softmax backward, g_q, g_k, g_v (attn mode); the AV z-rule from
//     S1 = R1f / ctx, the mask-Add split Sm = cam1 / (scaled + mask),
//     M = scaled ⊙ Sm, the QKᵀ z-rule S2u = M / raw (rule mode);
//     gc = mean_h (g_probs ⊙ cam1)⁺; the mask-Add sums Σ M, Σ mask ⊙ Sm,
//     Σ cam1 over every head and all of (S, S), per sample
//   combine: λ = safe_divide(|ΣM| / (|ΣM| + |Σmask·Sm|) · Σcam1, ΣM)
//     scales the q and k relevances (every rule below is linear in them);
//     g_in = g_sum1 + g_qkv·Wqkv (mxu); the stacked q/k/v rule (rule
//     mode) and the nested clones (BERT.py:319, :227) -> R_in.
//
// What bounds it on the H100: the weights and the (h, S, S) per-head maps
// do not fit in shared memory, so this is a sequence of launches over the
// whole batch: GEMMs on the core of gemm.cuh with the rules in their
// epilogues, the LayerNorm backward row kernel, the two-pass add rule, and
// the attention reverse as a row pass, the column pass and head mean of
// block_rev.cu (rules.cuh), then the combine. JAX's three TPU programs
// exist for the 128 MiB of VMEM; here one design serves every S <= 512.
// At S=512 a head's K and V (266 KB) do not fit in shared memory together,
// so the row pass keeps one K/V buffer and runs in three phases: K resident
// (scores, softmax), V resident (g_probs, the AV rule, the mask split), K
// resident again (g_q, the q z-rule), with each row's (S) vectors in shared
// memory in between. The per-sample sums of λ are per-block partials summed
// in a fixed order afterwards: deterministic, no atomics.
#include "bert_attn.cuh"
#include "rules.cuh"

namespace te {

// out = res + (pre + bias[c]) (res null: pre + bias[c]) over rows of width
// N: the forward epilogues' sums (EpiQkv, EpiResidual), formed again from
// their saved pre-bias products.
static __global__ void bias_add_kernel(const float* __restrict__ pre,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ res,
                                       float* __restrict__ out, size_t total,
                                       int N) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const float v = pre[o] + bias[o % N];
  out[o] = res ? res[o] + v : v;
}

inline int bias_add(const float* pre, const float* bias, const float* res,
                    float* out, size_t total, int N, cudaStream_t stream) {
  const int threads = 256;
  TE_LAUNCH(bias_add_kernel, (unsigned)((total + threads - 1) / threads),
            threads, 0, stream)(pre, bias, res, out, total, N);
  return (int)cudaGetLastError();
}

constexpr int kRevWarps = 8;

// Row pass: one block per (row tile, head, sample), one warp per query
// row. Emits g_q and the unscaled q relevance cqu = q ⊙ (S2u·K) / 2 into
// the q columns of g_qkv / cam_qkv, writes P (probs), G (g_raw), S2 (S2u),
// GCP (per-head (g_probs ⊙ cam1)⁺) and S1 to scratch for the column pass,
// and the block's three mask-Add sums to sums[b][h][tile].
template <bool RA, bool RR>
__global__ void bert_attn_rev_rows_kernel(
    const float* __restrict__ qkv, const float* __restrict__ mask,
    const float* __restrict__ ctx, const float* __restrict__ g_ctx,
    const float* __restrict__ R1f, float* __restrict__ g_qkv,
    float* __restrict__ cam_qkv, float* __restrict__ Pg,
    float* __restrict__ Gg, float* __restrict__ S2g,
    float* __restrict__ GCP, float* __restrict__ S1g,
    float* __restrict__ sums, int n, int H, int hd, float scale, int rows) {
  float* smem = reinterpret_cast<float*>(te_smem);
  const int ldk = hd + 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* KV = smem;                                  // [n][hd + 1]
  float* Rr = KV + head_kv_floats(n, hd);            // [rows][n]: raw, S2u
  float* Rp = Rr + (size_t)rows * n;                 // [rows][n]: probs
  float* Rg = Rp + (size_t)rows * n;                 // [rows][n]: g_probs, g_raw
  float* qw = Rg + (size_t)rows * n + (size_t)warp * 3 * hd;
  float* gw = qw + hd;                               // g_o row
  float* sw = gw + hd;                               // S1 row
  float* red = Rg + (size_t)rows * n + (size_t)nwarps * 3 * hd;  // [warps][3]

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv + (size_t)b * n * ld;
  const float* mrow = mask + (size_t)b * n;
  const size_t bh = (size_t)b * H + h, nn = (size_t)n * n;
  const int row0 = blockIdx.x * rows;
  const int nr = n - row0 < rows ? n - row0 : rows;

  auto load = [&](int part) {   // part 1: K, 2: V
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int j = idx / hd, d = idx - j * hd;
      KV[j * ldk + d] = base[(size_t)j * ld + part * D + h * hd + d];
    }
  };

  // phase 1: K resident; raw scores and probabilities, as the forward
  load(1);
  __syncthreads();
  for (int r = warp; r < nr; r += nwarps) {
    const float* qrow = base + (size_t)(row0 + r) * ld + h * hd;
    for (int d = lane; d < hd; d += kWarp) qw[d] = rnd<RA>(qrow[d]);
    __syncwarp();
    masked_softmax_row<RA>(qw, KV, ldk, n, hd, mrow, scale,
                           Rr + (size_t)r * n, Rp + (size_t)r * n, lane);
    __syncwarp();
  }
  __syncthreads();

  // phase 2: V resident; hook gradient, AV z-rule, mask-Add split, QKᵀ S
  load(2);
  __syncthreads();
  float sa = 0.f, sb = 0.f, sr = 0.f;
  for (int r = warp; r < nr; r += nwarps) {
    const int i = row0 + r;
    const size_t row_md = ((size_t)b * n + i) * D + h * hd;
    for (int d = lane; d < hd; d += kWarp) {
      gw[d] = g_ctx[row_md + d];
      const float s1 = safe_divide(R1f[row_md + d], ctx[row_md + d]);
      sw[d] = s1;
      S1g[(bh * n + i) * hd + d] = s1;
    }
    __syncwarp();
    float* rr = Rr + (size_t)r * n;
    const float* rp = Rp + (size_t)r * n;
    float* rg = Rg + (size_t)r * n;
    float inner = 0.f;
    for (int j = lane; j < n; j += kWarp) {
      const float* vr = KV + (size_t)j * ldk;
      float ga = 0.f, t = 0.f;
      for (int d = 0; d < hd; ++d) {
        ga = fmaf(rnd<RA>(gw[d]), rnd<RA>(vr[d]), ga);
        t = fmaf(rnd<RR>(sw[d]), rnd<RR>(vr[d]), t);
      }
      const float p = rp[j];
      inner = fmaf(ga, p, inner);
      const float cam1 = p * t * 0.5f;
      const float gcv = ga * cam1;
      GCP[bh * nn + (size_t)i * n + j] = gcv > 0.f ? gcv : 0.f;
      const float raw = rr[j], m = mrow[j];
      const float scaled = mul_rn(raw, scale);
      const float Sm = safe_divide(cam1, add_rn(scaled, m));
      const float M = scaled * Sm;
      rr[j] = safe_divide(M, raw);
      rg[j] = ga;
      sa += M;
      sb += m * Sm;
      sr += cam1;
    }
    inner = warp_sum(inner);
    for (int j = lane; j < n; j += kWarp) {
      const float gd = rp[j] * (rg[j] - inner) * scale;
      rg[j] = gd;
      const size_t o = bh * nn + (size_t)i * n + j;
      Gg[o] = gd;
      S2g[o] = rr[j];
      Pg[o] = rp[j];
    }
    __syncwarp();  // the next row overwrites gw and sw
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  sr = warp_sum(sr);
  if (lane == 0) {
    red[warp * 3 + 0] = sa;
    red[warp * 3 + 1] = sb;
    red[warp * 3 + 2] = sr;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * 3 + threadIdx.x];
    sums[(bh * gridDim.x + blockIdx.x) * 3 + threadIdx.x] = s;
  }

  // phase 3: K resident again; g_q = g_raw·K, cqu = q ⊙ (S2u·K) / 2
  load(1);
  __syncthreads();
  for (int r = warp; r < nr; r += nwarps) {
    const size_t row_q = ((size_t)b * n + row0 + r) * ld + h * hd;
    const float* rr = Rr + (size_t)r * n;
    const float* rg = Rg + (size_t)r * n;
    for (int d = lane; d < hd; d += kWarp) {
      float gq = 0.f, cq = 0.f;
      for (int j = 0; j < n; ++j) {
        const float kv = KV[j * ldk + d];
        gq = fmaf(rnd<RA>(rg[j]), rnd<RA>(kv), gq);
        cq = fmaf(rnd<RR>(rr[j]), rnd<RR>(kv), cq);
      }
      g_qkv[row_q + d] = gq;
      cam_qkv[row_q + d] = qkv[row_q + d] * cq * 0.5f;
    }
  }
}

// Rows per block of the row pass: the most (a multiple of the warps, at
// most 4 per warp) whose buffers fit beside one K/V buffer.
inline size_t rev_rows_smem(int n, int hd, int rows) {
  return sizeof(float) * (head_kv_floats(n, hd) + (size_t)3 * rows * n +
                          (size_t)kRevWarps * (3 * hd + 3));
}

inline int rev_rows(int n, int hd) {
  const size_t limit = (size_t)max_smem_optin();
  for (int per = 4; per >= 1; per /= 2)
    if (rev_rows_smem(n, hd, per * kRevWarps) <= limit) return per * kRevWarps;
  return 0;
}

// λ per sample from the row pass's partial sums, in a fixed order
static __global__ void mask_lambda_kernel(const float* __restrict__ sums,
                                          float* __restrict__ lam, int B,
                                          int per_sample) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float a = 0.f, m = 0.f, r = 0.f;
  const float* s = sums + (size_t)b * per_sample * 3;
  for (int k = 0; k < per_sample; ++k) {
    a += s[3 * k];
    m += s[3 * k + 1];
    r += s[3 * k + 2];
  }
  const float tot = fabsf(a) + fabsf(m);
  lam[b] = safe_divide(safe_divide(fabsf(a), tot) * r, a);
}

// the stacked q/k/v rule's S = safe_divide(R', (qkv_pre + |x|·|W|ᵀ) / 2),
// with R' = λ·R on the q and k columns (c < two_d) of sample r / n
struct EpiRuleDenLam {
  float* S; const float* R; const float* y_pre; const float* lam; int N;
  int two_d; int n;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    const float Rv = c < two_d ? lam[r / n] * R[o] : R[o];
    S[o] = safe_divide(Rv, 0.5f * (y_pre[o] + a));
  }
};

// the rule's relevance R_lin, then the 3-way clone and the 2-way clone
// with the residual branch: x ⊙ sd(x ⊙ sd(R_lin, x) + R2, x)
struct EpiRuleClone2 {
  float* out; const float* x; const float* R2; int N;
  __device__ void operator()(int r, int c, float a, float b) const {
    const size_t o = (size_t)r * N + c;
    const float xv = x[o];
    const float rule = 0.5f * (xv * a + fabsf(xv) * b);
    const float R_h1 = xv * safe_divide(rule, xv);
    out[o] = xv * safe_divide(R_h1 + R2[o], xv);
  }
};

struct AttnSaved {
  const float *qkv_pre, *ctx, *dense_nb;
};

template <bool RA, bool RR>
int bert_heads_rev(const float* qkv, const float* qkv_pre, const float* bqkv,
                   const float* mask, const float* ctx, const float* g_ctx,
                   const float* R1f, float* g_qkv, float* cam_qkv, float* P,
                   float* G, float* S2, float* GCP, float* S1, float* sums,
                   float* gc, int B, int n, int H, int hd, int rows,
                   float scale, cudaStream_t stream) {
  const size_t smem = rev_rows_smem(n, hd, rows);
  auto kern = bert_attn_rev_rows_kernel<RA, RR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(kern, grid, kRevWarps * kWarp, smem, stream)(
      qkv, mask, ctx, g_ctx, R1f, g_qkv, cam_qkv, P, G, S2, GCP, S1, sums, n,
      H, hd, scale, rows);
  TE_TRY((int)cudaGetLastError());
  return attn_rev_cols<RA, RR>(qkv_pre, bqkv, g_ctx, P, G, S2, S1, GCP,
                               g_qkv, cam_qkv, gc, B, n, H, hd, stream);
}

int bert_attn_rev(const float* x_in, const float* g_attln, const float* R_att,
                  const float* mask, const AttnSaved& sv,
                  const BlockWeights& w, float* g_in, float* R_in, float* gc,
                  char* work, size_t* work_bytes, int B, int n, int H, int hd,
                  float eps, int mxu, int attn_bf16, int rule_bf16, int rule,
                  cudaStream_t stream) {
  if (hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const int rows_per_block = rev_rows(n, hd);
  if (rows_per_block == 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n + rows_per_block - 1) / rows_per_block;
  const int D = H * hd, rows = B * n;
  const size_t rD = (size_t)rows * D, hnn = (size_t)B * H * n * n;
  Carve ws{work};
  float* qkv = ws.take<float>(3 * rD);
  float* att_mid = ws.take<float>(rD);
  float* g_sum1 = ws.take<float>(rD);
  float* g_ctx = ws.take<float>(rD);
  float* R1 = ws.take<float>(rD);        // add rule: the dense branch
  float* R2 = ws.take<float>(rD);        // add rule: the x_in branch
  float* Sd = ws.take<float>(rD);        // the dense rule's S
  float* R1f = ws.take<float>(rD);
  float* g_qkv = ws.take<float>(3 * rD);
  float* cam_qkv = ws.take<float>(3 * rD);
  float* Sq = ws.take<float>(3 * rD);
  float* P = ws.take<float>(hnn);
  float* G = ws.take<float>(hnn);
  float* S2 = ws.take<float>(hnn);
  float* GCP = ws.take<float>(hnn);
  float* S1 = ws.take<float>((size_t)B * H * n * hd);
  float* partials = ws.take<float>((size_t)B * kAddChunks * 3);
  float* sums = ws.take<float>((size_t)B * H * tiles * 3);
  float* lam = ws.take<float>(B);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const float scale = (float)pow((double)hd, -0.5);   // as hd ** -0.5
  const uint16_t *q_hi = w.wqkv_hi, *q_lo = w.wqkv_lo;
  const uint16_t *o_hi = w.wproj_hi, *o_lo = w.wproj_lo;

  // mid: LN1 backward, g_ctx, the add split, the dense rule
  TE_TRY(bias_add(sv.qkv_pre, w.bqkv, nullptr, qkv, 3 * rD, 3 * D, stream));
  TE_TRY(bias_add(sv.dense_nb, w.bproj, x_in, att_mid, rD, D, stream));
  TE_TRY(ln_bwd(g_attln, att_mid, w.ln1s, nullptr, g_sum1, rows, D, eps,
                stream));
  TE_TRY(gemm<false, false, false>(
      mxu, GemmArgs{g_sum1, o_hi, o_lo, D, D, rows, D, D}, EpiStore{g_ctx, D},
      stream));
  TE_TRY(add_rule(x_in, sv.dense_nb, w.bproj, R_att, partials, R2, R1, B, n,
                  D, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{sv.ctx, o_hi, o_lo, D, D, rows, D, D},
      EpiRuleDen{Sd, R1, sv.dense_nb, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sd, o_hi, o_lo, D, D, rows, D, D},
      EpiRuleNum{R1f, sv.ctx, D}, stream));

  // per head: row pass, column pass, head mean
  const auto heads =
      attn_bf16 ? (rule_bf16 ? bert_heads_rev<true, true>
                             : bert_heads_rev<true, false>)
                : (rule_bf16 ? bert_heads_rev<false, true>
                             : bert_heads_rev<false, false>);
  TE_TRY(heads(qkv, sv.qkv_pre, w.bqkv, mask, sv.ctx, g_ctx, R1f, g_qkv,
               cam_qkv, P, G, S2, GCP, S1, sums, gc, B, n, H, hd,
               rows_per_block, scale, stream));

  // combine: λ, g_in, the q/k/v rule and the nested clones
  TE_LAUNCH(mask_lambda_kernel, (B + 31) / 32, 32, 0, stream)(sums, lam, B,
                                                            H * tiles);
  TE_TRY((int)cudaGetLastError());
  TE_TRY(gemm<false, false, false>(
      mxu, GemmArgs{g_qkv, q_hi, q_lo, 3 * D, D, rows, D, 3 * D},
      EpiAdd{g_in, g_sum1, D}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{x_in, q_hi, q_lo, D, D, rows, 3 * D, D},
      EpiRuleDenLam{Sq, cam_qkv, sv.qkv_pre, lam, 3 * D, 2 * D, n}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sq, q_hi, q_lo, 3 * D, D, rows, D, 3 * D},
      EpiRuleClone2{R_in, x_in, R2, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x_in, g_attln, R_att, mask (B,
// n) additive; the slim anchors qkv_pre, ctx, dense_nb; the layer's vectors
// attn_ln scale, bias, out_ln scale, bias, b_qkv, b_ao, b_i, b_o; the weight
// planes (hi, lo) of qkv, attention output, inter, out (lo may be null for
// one-pass modes; this kernel reads qkv and attention output); the outputs
// g_in, R_in, gc (B, n, n); the workspace (null: only write its size to
// *work_bytes). Modes: mxu and rule (the GEMMs) 0 = bf16, 1 = bf16×3;
// attn_bf16 and rule_bf16 (the attention's gradient and rule products)
// 1 = bf16 operands, 0 = float32.
extern "C" int te_bert_attn_rev_f32(
    const void* x_in, const void* g_attln, const void* R_att,
    const void* mask, const void* qkv_pre, const void* ctx,
    const void* dense_nb, const void* ln1s, const void* ln1b,
    const void* ln2s, const void* ln2b, const void* bqkv, const void* bao,
    const void* bi, const void* bo, const void* wqkv_hi, const void* wqkv_lo,
    const void* wao_hi, const void* wao_lo, const void* wi_hi,
    const void* wi_lo, const void* wo_hi, const void* wo_lo, void* g_in,
    void* R_in, void* gc, void* work, void* work_bytes, int B, int n, int H,
    int hd, double eps, int mxu, int attn_bf16, int rule_bf16, int rule,
    void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{
      static_cast<F>(ln1s), static_cast<F>(ln1b), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(bqkv), static_cast<F>(bao),
      static_cast<F>(bi), static_cast<F>(bo), static_cast<W>(wqkv_hi),
      static_cast<W>(wqkv_lo), static_cast<W>(wao_hi), static_cast<W>(wao_lo),
      static_cast<W>(wi_hi), static_cast<W>(wi_lo), static_cast<W>(wo_hi),
      static_cast<W>(wo_lo)};
  te::AttnSaved sv{static_cast<F>(qkv_pre), static_cast<F>(ctx),
                   static_cast<F>(dense_nb)};
  return te::bert_attn_rev(
      static_cast<F>(x_in), static_cast<F>(g_attln), static_cast<F>(R_att),
      static_cast<F>(mask), sv, w, static_cast<float*>(g_in),
      static_cast<float*>(R_in), static_cast<float*>(gc),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), B, n, H, hd,
      (float)eps, mxu, attn_bf16, rule_bf16, rule,
      static_cast<cudaStream_t>(stream));
}
