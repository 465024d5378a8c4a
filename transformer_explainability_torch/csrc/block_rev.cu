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
// and the attention reverse from the saved anchors. Intermediates go
// through one workspace in device memory. The rule epilogues, the add rule
// and the attention reverse's passes live in rules.cuh, shared with the
// BERT reverse kernels; the MLP half in mlp_rev.cuh, shared with mlp_rev.cu.
// At ViT-B/16 B=8 in production modes the GEMM core's launches take 0.62
// of the step's 1.15 ms on an H100 at 700 W, the attention reverse 0.45
// (row pass 0.30, column pass 0.13, the bias add and the head mean 0.02). The attention reverse is B9's row pass without the
// recompute, and the column pass, with their float32 products as register
// micro-tiles and their bf16 rule products on the tensor cores (rules.cuh
// says what bounds them); the row pass's 1 × 8 tiles (1.1 floats read from
// shared memory per FMA) and its one block an SM (129 KB of shared memory
// at n = 197) are what is left of it to improve.
#include "mlp_rev.cuh"

namespace te {

// ---------------------------------------------------------------------------
// Attention reverse from the saved anchors (_attn_rev_math with saved_attn
// and out_m). RA: gradient products on bf16 operands (else float32); the
// rule products run in bf16 (the only rule mode the wrapper admits). q, k,
// v = qkv_pre + bqkv, formed once into qkv with the forward's own add.
// ---------------------------------------------------------------------------

// Shared memory of the row pass, in floats: the (32, n) rows Rr (dots, then
// S2) and Rg (probs, then g_attn, then g_dots), padded to a multiple of the
// key tile plus 8; two K/V stages; the g_o and S1 tiles; the t tile.
struct BlkRowLayout {
  int Sp, lds;
  __host__ __device__ explicit BlkRowLayout(int n)
      : Sp((n + kKeyT - 1) / kKeyT * kKeyT), lds(Sp + 8) {}
  __host__ __device__ size_t floats() const {
    return (size_t)2 * kRowQ * lds + 2 * kKeyT * kLdk + 2 * kRowQ * kLdk +
           kRowQ * kLdt;
  }
};

// Row pass: one block of 256 threads per (tile of kRowQ = 32 query rows,
// head, sample), B9's row pass without its recompute (rules.cuh pieces).
// The rows' dots and probs arrive by cp.async; V, then K, stream through
// two shared-memory stages of kKeyT keys, the next tile in flight while the
// block works on this one. V sweep: g_attn = g_o·Vᵀ (float32 micro-tile, 1
// row × 8 keys a thread) and t = S1·Vᵀ (bf16, tensor cores), then per (i,
// j) cam1 = p·t/2, S2 = safe_divide(cam1, dots), GCP = (g_attn ⊙ cam1)⁺;
// the softmax backward G = p ⊙ (g_attn − inner)·scale. K sweep: g_q = G·K
// (float32) and cq = S2·K (bf16, tensor cores). Emits g_q and cam_q = q ⊙
// cq / 2, and writes G, S2, GCP and S1 for the column pass.
template <bool RA>
__global__ void __launch_bounds__(kRowThreads, 1) blk_attn_rev_rows_kernel(
    const float* __restrict__ qkv, const float* __restrict__ probs,
    const float* __restrict__ dots, const float* __restrict__ out_m,
    const float* __restrict__ g_o, const float* __restrict__ cam_o,
    float* __restrict__ g_qkv, float* __restrict__ cam_qkv,
    float* __restrict__ G, float* __restrict__ S2g,
    float* __restrict__ GCP, float* __restrict__ S1g, int n, int H, int hd,
    float scale) {
  const BlkRowLayout lay(n);
  const int lds = lay.lds, T = lay.Sp / kKeyT;
  float* Rr = reinterpret_cast<float*>(te_smem);   // [kRowQ][lds]
  float* Rg = Rr + kRowQ * lds;                    // [kRowQ][lds]
  float* KVs = Rg + kRowQ * lds;                   // [2][kKeyT][kLdk]
  float* Gs = KVs + 2 * kKeyT * kLdk;              // g_o tile
  float* S1s = Gs + kRowQ * kLdk;                  // S1 tile
  float* Ts = S1s + kRowQ * kLdk;                  // [kRowQ][kLdt]

  const int t = threadIdx.x, tx = t % kRowTx, ty = t / kRowTx;
  const int warp = t / kWarp, lane = t % kWarp, g = lane >> 2, t4 = lane & 3;
  const int mw = 16 * (warp & 1), nw = 16 * (warp >> 1);
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * kRowQ;
  const int nr = n - row0 < kRowQ ? n - row0 : kRowQ;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv + (size_t)b * n * ld + h * hd;
  const bool vec = tile_vec_ok(base, ld, hd);
  const size_t tile_o = ((size_t)b * H + h) * n * n + (size_t)row0 * n;
  const bool vec_rows = tile_vec_ok(dots + tile_o, n, n) &&
                        tile_vec_ok(probs + tile_o, n, n);

  // zeros where no copy writes: the columns hd … kMaxHeadDim of the stages
  for (int idx = t; idx < 2 * kKeyT * kMaxHeadDim; idx += kRowThreads) {
    const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
    if (c >= hd) KVs[r * kLdk + c] = 0.f;
  }
  rows_stage_go_s1<RA>(Gs, S1s, S1g, g_o, cam_o, out_m, b, h, H, n, row0, nr,
                       hd);
  load_tile_async(Rr, lds, dots + tile_o, n, nr, n, vec_rows);
  load_tile_async(Rg, lds, probs + tile_o, n, nr, n, vec_rows);
  cp_async_commit();

  // stream tile s: V for s < T, then K
  auto fetch = [&](int s) {
    const int j0 = (s % T) * kKeyT;
    stream_kv_tile(KVs + (s & 1) * kKeyT * kLdk,
                   base + (size_t)j0 * ld + (s < T ? 2 * D : D), ld,
                   n - j0 < kKeyT ? n - j0 : kKeyT, hd, vec);
  };

  uint32_t a1[4][4];                      // S1 as A fragments (V sweep)
  float gq[2][4], cq[2][4];               // g_q (SIMT) and cq (mma) rows
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) gq[e][i] = cq[e][i] = 0.f;
  float inner = 0.f;

  fetch(0);
  for (int s = 0; s < 2 * T; ++s) {
    if (s + 1 < 2 * T) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* st = KVs + (s & 1) * kKeyT * kLdk;
    if (RA) {   // the gradient products take K and V as bf16
      for (int idx = t; idx < kKeyT * kLdk; idx += kRowThreads)
        st[idx] = round_bf16(st[idx]);
      __syncthreads();
    }
    const int j0 = (s % T) * kKeyT;
    if (s < T) {
      if (s == 0) rows_s1_frags(S1s, mw, g, t4, a1);
      float ga[8];
      rows_av_products(a1, st, Gs, Ts, mw, nw, g, t4, ty, tx, ga);
      __syncthreads();   // Ts complete
      // the AV z-rule, the QKᵀ z-rule's S and (g_attn ⊙ cam1)⁺, per (i, j)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = tx + kRowTx * c, j = j0 + jl;
        float* rr = Rr + ty * lds + j;
        float* rg = Rg + ty * lds + j;
        if (ty < nr && j < n) {
          const float p = *rg;
          inner = fmaf(ga[c], p, inner);
          const float cam1 = p * Ts[ty * kLdt + jl] * 0.5f;
          const float gcv = ga[c] * cam1;
          GCP[tile_o + (size_t)ty * n + j] = gcv > 0.f ? gcv : 0.f;
          *rr = safe_divide(cam1, *rr);
          *rg = ga[c];
        } else {
          *rr = 0.f;
          *rg = 0.f;
        }
      }
    } else {
      rows_qk_products(Rr, Rg, lds, j0, st, mw, nw, g, t4, ty, tx, gq, cq);
    }
    __syncthreads();   // the stage and Ts are consumed
    if (s == T - 1) {
      rows_softmax_bwd<RA>(inner, probs + tile_o, G + tile_o, S2g + tile_o,
                           Rr, Rg, lds, n, nr, ty, tx, scale);
      __syncthreads();
    }
  }
  rows_store_q(gq, cq, qkv, g_qkv, cam_qkv, b, h, H, n, row0, nr, hd, mw, nw,
               g, t4, ty, tx);
}

template <bool RA>
int blk_attn_rev(const float* qkv, const float* probs, const float* dots,
                 const float* out_m, const float* g_o, const float* cam_o,
                 float* g_qkv, float* cam_qkv, float* gc, float* G, float* S2,
                 float* GCP, float* S1, int B, int n, int H, int hd,
                 float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * BlkRowLayout(n).floats();
  if (smem > (size_t)max_smem_optin()) return (int)cudaErrorInvalidValue;
  auto kern = blk_attn_rev_rows_kernel<RA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRowQ - 1) / kRowQ, H, B);
  TE_LAUNCH(kern, grid, kRowThreads, smem, stream)(
      qkv, probs, dots, out_m, g_o, cam_o, g_qkv, cam_qkv, G, S2, GCP, S1, n,
      H, hd, scale);
  TE_TRY((int)cudaGetLastError());
  return attn_rev_cols<RA>(qkv, g_o, probs, G, S2, S1, GCP, g_qkv, cam_qkv,
                           gc, B, n, H, hd, stream);
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
  // the rule products run on the tensor cores in bf16 only (the wrapper's
  // mode tables admit no other rule mode for this kernel)
  if (hd > kMaxHeadDim || !rule_bf16) return (int)cudaErrorInvalidValue;
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
  float* qkv = ws.take<float>(3 * rD);
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
      rule, GemmArgs{out_m, w.wproj_ahi, w.wproj_alo, D, D, rows, D, D},
      EpiRuleDen{Sp, Ra2, sv.proj_pre, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sp, p_hi, p_lo, D, D, rows, D, D, w.wproj_ahi,
                     w.wproj_alo},
      EpiRuleNum{cam_o, out_m, D}, stream));

  // attention core
  TE_TRY(bias_add(sv.qkv_pre, w.bqkv, nullptr, qkv, 3 * rD, 3 * D, stream));
  const auto attn = attn_bf16 ? blk_attn_rev<true> : blk_attn_rev<false>;
  TE_TRY(attn(qkv, sv.probs, sv.dots, out_m, g_om, cam_o, g_qkv, cam_qkv, gc,
              G, S2, GCP, S1, B, n, H, hd, scale, stream));

  // qkv-side tails
  TE_TRY(gemm<false, false, false>(
      mxu, GemmArgs{g_qkv, q_hi, q_lo, 3 * D, D, rows, D, 3 * D},
      EpiStore{t_D, D}, stream));
  TE_TRY(ln_bwd(t_D, x_in, w.ln1s, g_mid, g_in, rows, D, eps, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{xn1, w.wqkv_ahi, w.wqkv_alo, D, D, rows, 3 * D, D},
      EpiRuleDen{Sq, cam_qkv, sv.qkv_pre, 3 * D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sq, q_hi, q_lo, 3 * D, D, rows, D, 3 * D, w.wqkv_ahi,
                     w.wqkv_alo},
      EpiRuleClone{R_in, xn1, Ra1, x_in, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x_in, x_mid, out_m, g_out, R; the
// saved anchors qkv_pre, proj_pre, dots, probs, fc1_pre, fc2_pre; ln1s,
// ln1b, ln2s, ln2b, bqkv, bproj, b1, b2; the weight planes (hi, lo) of qkv,
// proj, fc1, fc2 (lo may be null for one-pass modes), then the same of |W|
// (precision.PreparedWeight.abs); the outputs g_in,
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
    const void* w1_lo, const void* w2_hi, const void* w2_lo,
    const void* wqkv_ahi, const void* wqkv_alo, const void* wproj_ahi,
    const void* wproj_alo, const void* w1_ahi, const void* w1_alo,
    const void* w2_ahi, const void* w2_alo, void* g_in, void* R_in, void* gc, void* work, void* work_bytes, int B, int n, int H,
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
  te::set_abs_planes(w, {wqkv_ahi, wqkv_alo, wproj_ahi, wproj_alo, w1_ahi,
                         w1_alo, w2_ahi, w2_alo});
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
