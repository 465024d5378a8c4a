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
// What bounds it on the H100: operations. At BERT-base B=8, S=512 the
// attention's five float32 products (raw, g_probs, g_q in the row pass;
// g_k, g_v in the column pass) are 16.1 GFLOP off the tensor cores (0.24
// ms at 67 TFLOP/s), beside 71 GFLOP of bf16 and 58 GFLOP of bf16×3 GEMM
// passes on the tensor cores (0.13 ms): 0.371 ms in all. The weights and
// the (h, S, S) per-head maps do not fit in shared memory, so this is a
// sequence of launches over the whole batch: GEMMs on the core of gemm.cuh
// with the rules in their epilogues, the LayerNorm backward row kernel, the
// two-pass add rule, the attention reverse as the row pass below and the
// column pass and head mean of rules.cuh (shared with block_rev.cu), then
// the combine. JAX's three TPU programs exist for the 128 MiB of VMEM; here
// one design serves every S <= 512 and hd <= 64.
// The row pass streams the head's K and V through two shared-memory stages
// of 64 keys (cp.async) for a tile of 32 query rows: 3·S·hd floats from L2
// per 32 rows. The tile's
// (32, S) rows stay in shared memory between its three sweeps, the float32
// products are register micro-tiles and the bf16 rule products run on the
// tensor cores (mma.sync). The per-sample sums of λ are per-block partials
// summed in a fixed order afterwards: deterministic, no atomics.
// The probabilities are bitwise B7's (bert_fwd.cu), which the AV z-rule's
// S1 = R1 / ctx needs: both form them by bert_attn.cuh's score_tile and
// masked_softmax_rows (each raw score one FMA chain over d = 0 … hd−1 in
// order; x = raw·scale + mask by non-contracting operations; the max, exp,
// sum and divide with lane l over j ≡ l (mod 32) ascending, then the
// butterfly), whatever tile shape each kernel gives its threads.
#include "bert_attn.cuh"
#include "rules.cuh"

namespace te {

// Row pass: one block of 256 threads per (tile of kRowQ = 32 query rows,
// head, sample). The head's K and V stream through a ring of two
// shared-memory stages of kKeyT = 64 keys (16-byte cp.async, the next tile
// in flight while the block works on this one) in three sweeps: K (raw
// scores), V (g_probs, the AV rule, the mask split), K (g_q, the q z-rule).
// Between them the tile's (32, S) raw / S2u and p / g_probs / g_raw rows
// stay in shared memory. Emits g_q and the unscaled q relevance cqu = q ⊙
// (S2u·K) / 2 into the q columns of g_qkv / cam_qkv, writes P (probs), G
// (g_raw), S2 (S2u), GCP (per-head (g_probs ⊙ cam1)⁺) and S1 to scratch for
// the column pass, and the block's three mask-Add sums to sums[b][h][tile].
//
// Thread (ty, tx) = (t / 8, t % 8) owns query row ty. The float32 products
// (raw = q·Kᵀ, g_probs = g_o·Vᵀ, g_q = g_raw·K) are register micro-tiles:
// keys tx + 8c of a tile (c < 8; distinct banks for the 16-byte reads), or
// columns 4tx + 32e … + 3 of g_q; 16-byte shared reads, 9 per 32 FMAs. The
// bf16 rule products (t = S1·Vᵀ, cq = S2u·K) run on the tensor cores
// (mma.sync m16n8k16): warp w owns rows 16(w % 2) … + 15 and the 16 keys
// (or columns) 16(w / 2) … + 15, so t lands in a shared tile for the
// epilogue and cq stays in registers over the whole K sweep. The scores and
// the softmax are bert_attn.cuh's, as B7 forms them; the V and K sweeps'
// products and the softmax backward are rules.cuh's, shared with B3.

// Shared memory of the row pass, in floats: the (32, S) rows Rr (raw, then
// S2u) and Rg (x, e, p, then g_probs, then g_raw), padded to a multiple of
// the key tile plus 8 (≡ 8 mod 32: conflict-free rows); two K/V stages; the
// q, g_o and S1 tiles; the t tile; the mask row; the reduction slots.
struct RowLayout {
  int Sp, lds;
  __host__ __device__ explicit RowLayout(int n)
      : Sp((n + kKeyT - 1) / kKeyT * kKeyT), lds(Sp + 8) {}
  __host__ __device__ size_t floats() const {
    return (size_t)2 * kRowQ * lds + 2 * kKeyT * kLdk + 3 * kRowQ * kLdk +
           kRowQ * kLdt + Sp + 3 * (kRowThreads / kWarp);
  }
};

template <bool RA>
__global__ void __launch_bounds__(kRowThreads, 1) bert_attn_rev_rows_kernel(
    const float* __restrict__ qkv, const float* __restrict__ mask,
    const float* __restrict__ ctx, const float* __restrict__ g_ctx,
    const float* __restrict__ R1f, float* __restrict__ g_qkv,
    float* __restrict__ cam_qkv, float* __restrict__ Pg,
    float* __restrict__ Gg, float* __restrict__ S2g,
    float* __restrict__ GCP, float* __restrict__ S1g,
    float* __restrict__ sums, int n, int H, int hd, float scale) {
  const RowLayout lay(n);
  const int lds = lay.lds, Sp = lay.Sp, T = Sp / kKeyT;
  float* Rr = reinterpret_cast<float*>(te_smem);   // [kRowQ][lds]
  float* Rg = Rr + kRowQ * lds;                    // [kRowQ][lds]
  float* KVs = Rg + kRowQ * lds;                   // [2][kKeyT][kLdk]
  float* Qs = KVs + 2 * kKeyT * kLdk;              // [kRowQ][kLdk]
  float* Gs = Qs + kRowQ * kLdk;                   // g_o tile
  float* S1s = Gs + kRowQ * kLdk;                  // S1 tile
  float* Ts = S1s + kRowQ * kLdk;                  // [kRowQ][kLdt]
  float* ms = Ts + kRowQ * kLdt;                   // [Sp] mask row
  float* red = ms + Sp;                            // [warps][3]

  const int t = threadIdx.x, tx = t % kRowTx, ty = t / kRowTx;
  const int warp = t / kWarp, lane = t % kWarp, g = lane >> 2, t4 = lane & 3;
  const int mw = 16 * (warp & 1), nw = 16 * (warp >> 1);
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * kRowQ;
  const int nr = n - row0 < kRowQ ? n - row0 : kRowQ;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv + (size_t)b * n * ld + h * hd;
  const bool vec = tile_vec_ok(base, ld, hd);
  const size_t bh = (size_t)b * H + h, nn = (size_t)n * n;
  const size_t tile_o = bh * nn + (size_t)row0 * n;   // the rows' maps

  // zeros where no copy writes: the columns hd … kMaxHeadDim of the stages
  // and of the q tile (every product runs over all 64 columns; a zero term
  // leaves a sum unchanged), the q rows past n
  for (int idx = t; idx < 2 * kKeyT * kMaxHeadDim; idx += kRowThreads) {
    const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
    if (c >= hd) KVs[r * kLdk + c] = 0.f;
  }
  for (int idx = t; idx < kRowQ * kMaxHeadDim; idx += kRowThreads) {
    const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
    if (r >= nr || c >= hd) Qs[r * kLdk + c] = 0.f;
  }
  rows_stage_go_s1<RA>(Gs, S1s, S1g, g_ctx, R1f, ctx, b, h, H, n, row0, nr,
                       hd);
  for (int j = t; j < Sp; j += kRowThreads)
    ms[j] = j < n ? mask[(size_t)b * n + j] : 0.f;
  load_tile(Qs, kLdk, base + (size_t)row0 * ld, ld, nr, hd, vec);
  cp_async_commit();

  // stream tile s: K for s < T and s >= 2T, V between
  auto fetch = [&](int s) {
    const int j0 = (s % T) * kKeyT, part = s / T == 1 ? 2 : 1;
    stream_kv_tile(KVs + (s & 1) * kKeyT * kLdk,
                   base + (size_t)j0 * ld + part * D, ld,
                   n - j0 < kKeyT ? n - j0 : kKeyT, hd, vec);
  };

  uint32_t a1[4][4];                      // S1 as A fragments (sweep 2)
  float gq[2][4], cq[2][4];               // g_q (SIMT) and cq (mma) rows
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) gq[e][i] = cq[e][i] = 0.f;
  float inner = 0.f, sa = 0.f, sb = 0.f, sr = 0.f;

  fetch(0);
  for (int s = 0; s < 3 * T; ++s) {
    if (s + 1 < 3 * T) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* st = KVs + (s & 1) * kKeyT * kLdk;
    if (RA) {   // the attention products take K, V, q and g_o as bf16
      for (int idx = t; idx < kKeyT * kLdk; idx += kRowThreads)
        st[idx] = round_bf16(st[idx]);
      if (s == 0)
        for (int idx = t; idx < kRowQ * kLdk; idx += kRowThreads)
          Qs[idx] = round_bf16(Qs[idx]);
      __syncthreads();
    }
    const int j0 = (s % T) * kKeyT;

    if (s < T) {
      // sweep 1: raw = q·kᵀ (bert_attn.cuh, as B7)
      float acc[1][8];
      score_tile<1, 8, kRowQ, kRowTx>(Qs, st, ty, tx, acc);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        Rr[ty * lds + j0 + tx + kRowTx * c] = acc[0][c];
    } else if (s < 2 * T) {
      // sweep 2: t = S1·Vᵀ (bf16, tensor cores) into Ts, g_probs = g_o·vᵀ
      if (s == T) rows_s1_frags(S1s, mw, g, t4, a1);
      float ga[8];
      rows_av_products(a1, st, Gs, Ts, mw, nw, g, t4, ty, tx, ga);
      __syncthreads();   // Ts complete
      // the AV z-rule, the mask-Add split and the QKᵀ z-rule's S, per (i, j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = tx + kRowTx * c, j = j0 + jl;
        float* rr = Rr + ty * lds + j;
        float* rg = Rg + ty * lds + j;
        if (ty < nr && j < n) {
          const float p = *rg, raw = *rr, m = ms[j];
          inner = fmaf(ga[c], p, inner);
          const float cam1 = p * Ts[ty * kLdt + jl] * 0.5f;
          const float gcv = ga[c] * cam1;
          const size_t o = tile_o + (size_t)ty * n + j;
          GCP[o] = gcv > 0.f ? gcv : 0.f;
          Pg[o] = p;
          const float scaled = mul_rn(raw, scale);
          const float Sm = safe_divide(cam1, add_rn(scaled, m));
          const float M = scaled * Sm;
          *rr = safe_divide(M, raw);
          *rg = ga[c];
          sa += M;
          sb += m * Sm;
          sr += cam1;
        } else {
          *rr = 0.f;
          *rg = 0.f;
        }
      }
    } else {
      // sweep 3: g_q = g_raw·K (float32), cq = S2u·K (bf16, tensor cores)
      rows_qk_products(Rr, Rg, lds, j0, st, mw, nw, g, t4, ty, tx, gq, cq);
    }
    __syncthreads();   // the stage and Ts are consumed

    if (s == T - 1) {
      // the masked softmax (bert_attn.cuh, as B7): p bitwise the forward's
      masked_softmax_rows<kRowQ / (kRowThreads / kWarp)>(
          Rr, Rg, lds, nr, n, ms, scale, warp, kRowThreads / kWarp, lane);
      __syncthreads();
    } else if (s == 2 * T - 1) {
      // the softmax backward; p comes back from P, which this thread wrote
      rows_softmax_bwd<RA>(inner, Pg + tile_o, Gg + tile_o, S2g + tile_o, Rr,
                           Rg, lds, n, nr, ty, tx, scale);
      __syncthreads();
    }
  }

  // the block's mask-Add sums, in a fixed order
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  sr = warp_sum(sr);
  if (lane == 0) {
    red[warp * 3 + 0] = sa;
    red[warp * 3 + 1] = sb;
    red[warp * 3 + 2] = sr;
  }
  __syncthreads();
  if (t < 3) {
    float acc = 0.f;
    for (int w = 0; w < kRowThreads / kWarp; ++w) acc += red[w * 3 + t];
    sums[(bh * gridDim.x + blockIdx.x) * 3 + t] = acc;
  }
  rows_store_q(gq, cq, qkv, g_qkv, cam_qkv, b, h, H, n, row0, nr, hd, mw, nw,
               g, t4, ty, tx);
}

inline size_t rev_rows_smem(int n) {
  return sizeof(float) * RowLayout(n).floats();
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
  struct In { float R, y_pre, lam; };
  __device__ In load(int r, int c) const {
    const size_t o = (size_t)r * N + c;
    return {R[o], y_pre[o], c < two_d ? lam[r / n] : 0.f};
  }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    const float Rv = c < two_d ? in.lam * in.R : in.R;
    S[(size_t)r * N + c] = safe_divide(Rv, 0.5f * (in.y_pre + a));
  }
};

// the rule's relevance R_lin, then the 3-way clone and the 2-way clone
// with the residual branch: x ⊙ sd(x ⊙ sd(R_lin, x) + R2, x)
struct EpiRuleClone2 {
  float* out; const float* x; const float* R2; int N;
  struct In { float x, R2; };
  __device__ In load(int r, int c) const {
    const size_t o = (size_t)r * N + c;
    return {x[o], R2[o]};
  }
  __device__ void operator()(int r, int c, float a, float b,
                             const In& in) const {
    const float xv = in.x;
    const float rule = 0.5f * (xv * a + fabsf(xv) * b);
    const float R_h1 = xv * safe_divide(rule, xv);
    out[(size_t)r * N + c] = xv * safe_divide(R_h1 + in.R2, xv);
  }
};

struct AttnSaved {
  const float *qkv_pre, *ctx, *dense_nb;
};

template <bool RA>
int bert_heads_rev(const float* qkv, const float* mask, const float* ctx,
                   const float* g_ctx, const float* R1f, float* g_qkv, float* cam_qkv, float* P,
                   float* G, float* S2, float* GCP, float* S1, float* sums,
                   float* gc, int B, int n, int H, int hd, float scale,
                   cudaStream_t stream) {
  const size_t smem = rev_rows_smem(n);
  auto kern = bert_attn_rev_rows_kernel<RA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRowQ - 1) / kRowQ, H, B);
  TE_LAUNCH(kern, grid, kRowThreads, smem, stream)(
      qkv, mask, ctx, g_ctx, R1f, g_qkv, cam_qkv, P, G, S2, GCP, S1, sums, n,
      H, hd, scale);
  TE_TRY((int)cudaGetLastError());
  return attn_rev_cols<RA ? kModeBf16 : kModeF32>(
      qkv, g_ctx, P, G, S2, S1, GCP, g_qkv, cam_qkv, gc, B, n, H, hd,
      stream);
}

int bert_attn_rev(const float* x_in, const float* g_attln, const float* R_att,
                  const float* mask, const AttnSaved& sv,
                  const BlockWeights& w, float* g_in, float* R_in, float* gc,
                  char* work, size_t* work_bytes, int B, int n, int H, int hd,
                  float eps, int mxu, int attn_bf16, int rule_bf16, int rule,
                  cudaStream_t stream) {
  // bf16 rule products (on the tensor cores) and float32 or bf16 gradient
  // products only: no bf16×3 instance (ROADMAP B, raw tensorfloat32 (BERT))
  if (hd > kMaxHeadDim || rule_bf16 != 1 ||
      (attn_bf16 != 0 && attn_bf16 != 1) ||
      rev_rows_smem(n) > (size_t)max_smem_optin())
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + kRowQ - 1) / kRowQ;
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
      rule, GemmArgs{sv.ctx, w.wproj_ahi, w.wproj_alo, D, D, rows, D, D},
      EpiRuleDen{Sd, R1, sv.dense_nb, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sd, o_hi, o_lo, D, D, rows, D, D, w.wproj_ahi,
                     w.wproj_alo},
      EpiRuleNum{R1f, sv.ctx, D}, stream));

  // per head: row pass, column pass, head mean
  const auto heads = attn_bf16 ? bert_heads_rev<true> : bert_heads_rev<false>;
  TE_TRY(heads(qkv, mask, sv.ctx, g_ctx, R1f, g_qkv,
               cam_qkv, P, G, S2, GCP, S1, sums, gc, B, n, H, hd, scale,
               stream));

  // combine: λ, g_in, the q/k/v rule and the nested clones
  TE_LAUNCH(mask_lambda_kernel, (B + 31) / 32, 32, 0, stream)(sums, lam, B,
                                                            H * tiles);
  TE_TRY((int)cudaGetLastError());
  TE_TRY(gemm<false, false, false>(
      mxu, GemmArgs{g_qkv, q_hi, q_lo, 3 * D, D, rows, D, 3 * D},
      EpiAdd{g_in, g_sum1, D}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{x_in, w.wqkv_ahi, w.wqkv_alo, D, D, rows, 3 * D, D},
      EpiRuleDenLam{Sq, cam_qkv, sv.qkv_pre, lam, 3 * D, 2 * D, n}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sq, q_hi, q_lo, 3 * D, D, rows, D, 3 * D, w.wqkv_ahi,
                     w.wqkv_alo},
      EpiRuleClone2{R_in, x_in, R2, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x_in, g_attln, R_att, mask (B,
// n) additive; the slim anchors qkv_pre, ctx, dense_nb; the layer's vectors
// attn_ln scale, bias, out_ln scale, bias, b_qkv, b_ao, b_i, b_o; the weight
// planes (hi, lo) of qkv, attention output, inter, out (lo may be null for
// one-pass modes; this kernel reads qkv and attention output), then the
// same of |W| (precision.PreparedWeight.abs); the outputs g_in, R_in, gc
// (B, n, n); the workspace (null: only write its size to *work_bytes). Modes: mxu and rule (the GEMMs) 0 = bf16, 1 = bf16×3;
// attn_bf16 and rule_bf16 (the attention's gradient and rule products)
// 1 = bf16 operands, 0 = float32.
extern "C" int te_bert_attn_rev_f32(
    const void* x_in, const void* g_attln, const void* R_att,
    const void* mask, const void* qkv_pre, const void* ctx,
    const void* dense_nb, const void* ln1s, const void* ln1b,
    const void* ln2s, const void* ln2b, const void* bqkv, const void* bao,
    const void* bi, const void* bo, const void* wqkv_hi, const void* wqkv_lo,
    const void* wao_hi, const void* wao_lo, const void* wi_hi,
    const void* wi_lo, const void* wo_hi, const void* wo_lo,
    const void* wqkv_ahi, const void* wqkv_alo, const void* wao_ahi,
    const void* wao_alo, const void* wi_ahi, const void* wi_alo,
    const void* wo_ahi, const void* wo_alo, void* g_in,
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
  te::set_abs_planes(w, {wqkv_ahi, wqkv_alo, wao_ahi, wao_alo, wi_ahi, wi_alo,
                         wo_ahi, wo_alo});
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
