// Pieces of the reverse kernels shared by block_rev.cu (ViT) and
// bert_out_rev.cu / bert_attn_rev.cu (BERT): the GEMM epilogues of the LRP
// rules, the 'ours' add rule with deterministic per-sample sums, and the
// column and head-mean passes of the attention reverse (also B5's,
// attn_rev.cu).
#pragma once

#include "gemm.cuh"

namespace te {

// (the epilogues' two calls: gemm.cuh, before EpiQkv)
struct EpiStore {
  float* C; int N;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int r, int c, float a, float, const In&) const {
    C[(size_t)r * N + c] = a;
  }
};

// both products of a dual GEMM, stored apart (A·W and A·|W|)
struct EpiStore2 {
  float* C; float* Cabs; int N;
  struct In {};
  __device__ In load(int, int) const { return {}; }
  __device__ void operator()(int r, int c, float a, float b, const In&) const {
    const size_t o = (size_t)r * N + c;
    C[o] = a;
    Cabs[o] = b;
  }
};

// out = base + A·B (a backward product joining its residual branch)
struct EpiAdd {
  float* out; const float* base; int N;
  struct In { float base; };
  __device__ In load(int r, int c) const { return {base[(size_t)r * N + c]}; }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    out[(size_t)r * N + c] = in.base + a;
  }
};

// g_h1 = (g_out·W2) ⊙ gelu′(h1), and hg = gelu(h1), h1 = fc1_pre + b1
struct EpiGeluGrad {
  float* g_h1; float* hg; const float* fc1_pre; const float* b1; int N;
  static constexpr bool kLong = true;
  struct In { float pre, b1; };
  __device__ In load(int r, int c) const {
    return {fc1_pre[(size_t)r * N + c], b1[c]};
  }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    const size_t o = (size_t)r * N + c;
    const float h = in.pre + in.b1;
    g_h1[o] = a * gelu_grad(h);
    hg[o] = gelu(h);
  }
};

// the rule's S = safe_divide(R, (y_pre + |x|·|W|ᵀ) / 2)
struct EpiRuleDen {
  float* S; const float* R; const float* y_pre; int N;
  struct In { float R, y_pre; };
  __device__ In load(int r, int c) const {
    const size_t o = (size_t)r * N + c;
    return {R[o], y_pre[o]};
  }
  __device__ void operator()(int r, int c, float a, float, const In& in) const {
    S[(size_t)r * N + c] = safe_divide(in.R, 0.5f * (in.y_pre + a));
  }
};

// the rule's relevance (x ⊙ S·W + |x| ⊙ S·|W|) / 2
struct EpiRuleNum {
  float* out; const float* x; int N;
  struct In { float x; };
  __device__ In load(int r, int c) const { return {x[(size_t)r * N + c]}; }
  __device__ void operator()(int r, int c, float a, float b,
                             const In& in) const {
    const float xv = in.x;
    out[(size_t)r * N + c] = 0.5f * (xv * a + fabsf(xv) * b);
  }
};

// the rule's relevance, then the clone merge with the other branch:
// xc ⊙ safe_divide(R_other + rule, xc)
struct EpiRuleClone {
  float* out; const float* x; const float* R_other; const float* xc; int N;
  struct In { float x, R_other, xc; };
  __device__ In load(int r, int c) const {
    const size_t o = (size_t)r * N + c;
    return {x[o], R_other[o], xc[o]};
  }
  __device__ void operator()(int r, int c, float a, float b,
                             const In& in) const {
    const float xv = in.x;
    const float rule = 0.5f * (xv * a + fabsf(xv) * b);
    out[(size_t)r * N + c] = in.xc * safe_divide(in.R_other + rule, in.xc);
  }
};

// ---------------------------------------------------------------------------
// The add rule (_add_rule_math) with per-sample sums over (n, D)
// ---------------------------------------------------------------------------

constexpr int kAddThreads = 256;
constexpr int kAddChunks = 48;    // partial sums per sample

__device__ __forceinline__ void add_terms(const float* a, const float* bpre,
                                          const float* bias, const float* R,
                                          size_t o, int c, float& Ca,
                                          float& Cb) {
  const float av = a[o], bv = bpre[o] + bias[c];
  const float S = safe_divide(R[o], av + bv);
  Ca = av * S;
  Cb = bv * S;
}

static __global__ void __launch_bounds__(kAddThreads)
add_partial_kernel(const float* __restrict__ a, const float* __restrict__ bpre,
                   const float* __restrict__ bias, const float* __restrict__ R,
                   float* __restrict__ partials, int E, int D) {
  float* red = reinterpret_cast<float*>(te_smem);   // [warps][3]
  const int chunk = (E + kAddChunks - 1) / kAddChunks;
  const int c = blockIdx.x, b = blockIdx.y;
  const int start = c * chunk, end = start + chunk < E ? start + chunk : E;
  float sa = 0.f, sb = 0.f, sr = 0.f;
  for (int e = start + threadIdx.x; e < end; e += kAddThreads) {
    const size_t o = (size_t)b * E + e;
    float Ca, Cb;
    add_terms(a, bpre, bias, R, o, e % D, Ca, Cb);
    sa += Ca;
    sb += Cb;
    sr += R[o];
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  sr = warp_sum(sr);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    red[warp * 3 + 0] = sa;
    red[warp * 3 + 1] = sb;
    red[warp * 3 + 2] = sr;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float s = 0.f;
    for (int w = 0; w < kAddThreads / kWarp; ++w) s += red[w * 3 + threadIdx.x];
    partials[((size_t)b * kAddChunks + c) * 3 + threadIdx.x] = s;
  }
}

static __global__ void __launch_bounds__(kAddThreads)
add_apply_kernel(const float* __restrict__ a, const float* __restrict__ bpre,
                 const float* __restrict__ bias, const float* __restrict__ R,
                 const float* __restrict__ partials, float* __restrict__ Ca_out,
                 float* __restrict__ Cb_out, int E, int D) {
  const int chunk = (E + kAddChunks - 1) / kAddChunks;
  const int c = blockIdx.x, b = blockIdx.y;
  // every thread sums the sample's partials in the same order
  float a_sum = 0.f, b_sum = 0.f, r_sum = 0.f;
  const float* p = partials + (size_t)b * kAddChunks * 3;
  for (int k = 0; k < kAddChunks; ++k) {
    a_sum += p[3 * k];
    b_sum += p[3 * k + 1];
    r_sum += p[3 * k + 2];
  }
  const float tot = fabsf(a_sum) + fabsf(b_sum);
  const float fa = safe_divide(safe_divide(fabsf(a_sum), tot) * r_sum, a_sum);
  const float fb = safe_divide(safe_divide(fabsf(b_sum), tot) * r_sum, b_sum);
  const int start = c * chunk, end = start + chunk < E ? start + chunk : E;
  for (int e = start + threadIdx.x; e < end; e += kAddThreads) {
    const size_t o = (size_t)b * E + e;
    float Ca, Cb;
    add_terms(a, bpre, bias, R, o, e % D, Ca, Cb);
    Ca_out[o] = Ca * fa;
    Cb_out[o] = Cb * fb;
  }
}

// (Ca, Cb) of the add a + (bpre + bias) for relevance R, each (B, n, D)
inline int add_rule(const float* a, const float* bpre, const float* bias,
             const float* R, float* partials, float* Ca, float* Cb, int B,
             int n, int D, cudaStream_t stream) {
  const int E = n * D;
  dim3 grid(kAddChunks, B);
  TE_LAUNCH(add_partial_kernel, grid, kAddThreads,
            3 * sizeof(float) * (kAddThreads / kWarp), stream)(
      a, bpre, bias, R, partials, E, D);
  TE_TRY((int)cudaGetLastError());
  TE_LAUNCH(add_apply_kernel, grid, kAddThreads, 0, stream)(
      a, bpre, bias, R, partials, Ca, Cb, E, D);
  return (int)cudaGetLastError();
}

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

// ---------------------------------------------------------------------------
// The attention reverse over a head's (n, n) maps, shared by block_rev.cu
// (B3, ViT, from the saved probs and dots) and bert_attn_rev.cu (B9, BERT,
// which recomputes them): the pieces of the row pass and the whole column
// pass and head mean, which attn_rev.cu (B5) runs too. q, k, v arrive with
// their bias added (qkv), as the forward formed them. Every product runs
// over hd ≤ kMaxHeadDim columns; a tile's columns hd … kMaxHeadDim are zero
// where they are summed over.
//
// What bounds them on the H100: operations, on the CUDA cores. At BERT-base
// B=8, S=512 each of the attention's float32 products is 3.2 GFLOP (0.048
// ms at 67 TFLOP/s); the (B, h, S, S) maps the passes exchange are 100 MB
// each (0.03 ms at 3.35 TB/s). A float32 product as a register micro-tile
// is bounded by shared memory, which serves 32 floats a clock per SM beside
// 128 FMAs: a tile that reads r floats per FMA runs at most at 1/(4r) of
// the FP32 rate. The row pass's 1 × 8 tiles read 1.1; the column pass's
// 4 × 8 tiles 0.375, and it runs its two float32 products at 18 TFLOP/s
// (0.36 ms at S=512, 0.13 ms at ViT-B/16's n = 197, B=8, on an H100 at 700
// W). The bf16 rule products run on the tensor cores (mma.sync m16n8k16,
// float32 accumulators), their operands rounded once, as they are packed
// into fragments.
// ---------------------------------------------------------------------------

constexpr int kMaxHeadDim = 64;
constexpr int kKeyT = 64;                 // keys per streamed K/V tile
constexpr int kLdk = kMaxHeadDim + 4;     // pitch of a tile of d columns
constexpr int kRowQ = 32;                 // query rows per row-pass block
constexpr int kRowThreads = 256;
constexpr int kRowTx = 8;                 // row-pass threads per query row
constexpr int kLdt = kKeyT + 8;           // pitch of the t tile

// The row pass streams a head's K or V in tiles of kKeyT keys through a
// ring of two shared-memory stages; the tile's rows past n are zero (the
// columns hd … kMaxHeadDim are zeroed once, by the caller). Commits the
// copies as one batch.
__device__ __forceinline__ void stream_kv_tile(float* st, const float* src,
                                               size_t ld, int rows, int hd,
                                               bool vec) {
  for (int idx = threadIdx.x; idx < (kKeyT - rows) * hd; idx += blockDim.x)
    st[(rows + idx / hd) * kLdk + idx % hd] = 0.f;
  load_tile_async(st, kLdk, src, ld, rows, hd, vec);
  cp_async_commit();
}

// The row pass's g_o tile (as the gradient products take it) and S1 =
// safe_divide(num, den), the AV z-rule's S over the head's context, for
// query rows row0 … row0 + nr − 1 of sample b (rows of width D, the head's
// hd columns at h·hd); S1 is also written to S1g (B, h, n, hd) for the
// column pass. Rows past nr and columns past hd are zero.
template <bool RA>
__device__ __forceinline__ void rows_stage_go_s1(
    float* Gs, float* S1s, float* __restrict__ S1g,
    const float* __restrict__ g_o, const float* __restrict__ num,
    const float* __restrict__ den, int b, int h, int H, int n, int row0,
    int nr, int hd) {
  const int D = H * hd;
  const size_t bh = (size_t)b * H + h;
  for (int idx = threadIdx.x; idx < kRowQ * kMaxHeadDim; idx += blockDim.x) {
    const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
    float gv = 0.f, s1 = 0.f;
    if (r < nr && c < hd) {
      const size_t o = ((size_t)b * n + row0 + r) * D + h * hd + c;
      gv = g_o[o];
      s1 = safe_divide(num[o], den[o]);
      S1g[(bh * n + row0 + r) * hd + c] = s1;
    }
    Gs[r * kLdk + c] = rnd<RA>(gv);
    S1s[r * kLdk + c] = s1;
  }
}

// The rows' S1 as the A fragments of t = S1·Vᵀ (warp rows mw … mw + 15)
__device__ __forceinline__ void rows_s1_frags(const float* S1s, int mw, int g,
                                              int t4, uint32_t (&a1)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* r0 = S1s + (mw + g) * kLdk + 16 * kk + 2 * t4;
    const float* r1 = r0 + 8 * kLdk;
    a1[kk][0] = pack_bf16x2(r0[0], r0[1]);
    a1[kk][1] = pack_bf16x2(r1[0], r1[1]);
    a1[kk][2] = pack_bf16x2(r0[8], r0[9]);
    a1[kk][3] = pack_bf16x2(r1[8], r1[9]);
  }
}

// The V sweep's products on one tile st of kKeyT keys: t = S1·Vᵀ (bf16,
// tensor cores: warp (mw, nw) owns rows mw … + 15 and keys nw … + 15) into
// Ts, and the float32 micro-tile g_probs = g_o·Vᵀ of thread (ty, tx): row
// ty, keys tx + 8c. The caller synchronises before it reads Ts.
__device__ __forceinline__ void rows_av_products(
    const uint32_t (&a1)[4][4], const float* st, const float* Gs, float* Ts,
    int mw, int nw, int g, int t4, int ty, int tx, float (&ga)[8]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    float dacc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* vr = st + (nw + 8 * nb + g) * kLdk + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t bf[2] = {pack_bf16x2(vr[16 * kk], vr[16 * kk + 1]),
                              pack_bf16x2(vr[16 * kk + 8], vr[16 * kk + 9])};
      mma_bf16_16816(dacc, a1[kk], bf);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      Ts[(mw + g + 8 * (i >> 1)) * kLdt + nw + 8 * nb + 2 * t4 + (i & 1)] =
          dacc[i];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) ga[c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxHeadDim; d += 4) {
    float go[4], v[8][4];
    lds4(Gs + ty * kLdk + d, go);
#pragma unroll
    for (int c = 0; c < 8; ++c) lds4(st + (tx + kRowTx * c) * kLdk + d, v[c]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int c = 0; c < 8; ++c) ga[c] = fmaf(go[dd], v[c][dd], ga[c]);
  }
}

// After the V sweep: inner_i = Σ_j g_probs·p over the row's kRowTx threads
// (butterfly), then the softmax backward g_raw = p ⊙ (g_probs − inner) ·
// scale for the rows' keys j < n, with p from the (B, h, n, n) map Pg (row
// pitch n, at this block's rows): g_raw to Gg, the QKᵀ z-rule's S from Rr to
// S2g, and g_raw (as the gradient products take it) over g_probs in Rg.
template <bool RA>
__device__ __forceinline__ void rows_softmax_bwd(
    float inner, const float* __restrict__ Pg, float* __restrict__ Gg,
    float* __restrict__ S2g, const float* Rr, float* Rg, int lds, int n,
    int nr, int ty, int tx, float scale) {
#pragma unroll
  for (int o = kRowTx / 2; o > 0; o >>= 1)
    inner += __shfl_xor_sync(0xffffffffu, inner, o);
  if (ty < nr)
    for (int j = tx; j < n; j += kRowTx) {
      const size_t o = (size_t)ty * n + j;
      const float gd = Pg[o] * (Rg[ty * lds + j] - inner) * scale;
      Gg[o] = gd;
      S2g[o] = Rr[ty * lds + j];
      Rg[ty * lds + j] = rnd<RA>(gd);
    }
}

// The K sweep's products on one tile st of keys j0 … j0 + kKeyT − 1: g_q +=
// g_raw·K (float32 micro-tile of thread (ty, tx): row ty, columns 4tx +
// 32e … + 3) and cq += S2·K (bf16, tensor cores: warp (mw, nw) owns rows
// mw … + 15 and columns nw … + 15), from the rows' g_raw in Rg and S2 in Rr.
__device__ __forceinline__ void rows_qk_products(
    const float* Rr, const float* Rg, int lds, int j0, const float* st,
    int mw, int nw, int g, int t4, int ty, int tx, float (&gq)[2][4],
    float (&cq)[2][4]) {
  for (int jj = 0; jj < kKeyT; jj += 4) {
    float gr[4];
    lds4(Rg + ty * lds + j0 + jj, gr);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float k[4];
        lds4(st + (jj + u) * kLdk + 4 * tx + 32 * e, k);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
          gq[e][dd] = fmaf(gr[u], k[dd], gq[e][dd]);
      }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* r0 = Rr + (mw + g) * lds + j0 + 16 * kk + 2 * t4;
    const float* r1 = r0 + 8 * lds;
    const uint32_t af[4] = {pack_bf16x2(r0[0], r0[1]),
                            pack_bf16x2(r1[0], r1[1]),
                            pack_bf16x2(r0[8], r0[9]),
                            pack_bf16x2(r1[8], r1[9])};
    const float* kr = st + (16 * kk + 2 * t4) * kLdk + g;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const float* kc = kr + nw + 8 * nb;
      const uint32_t bf[2] = {pack_bf16x2(kc[0], kc[kLdk]),
                              pack_bf16x2(kc[8 * kLdk], kc[9 * kLdk])};
      mma_bf16_16816(cq[nb], af, bf);
    }
  }
}

// The row pass's q outputs: g_q into g_qkv and cam_q = q ⊙ cq / 2 into
// cam_qkv, at the q columns of rows row0 … row0 + nr − 1 of sample b
__device__ __forceinline__ void rows_store_q(
    const float (&gq)[2][4], const float (&cq)[2][4],
    const float* __restrict__ qkv, float* __restrict__ g_qkv,
    float* __restrict__ cam_qkv, int b, int h, int H, int n, int row0,
    int nr, int hd, int mw, int nw, int g, int t4, int ty, int tx) {
  const size_t ld = (size_t)3 * H * hd;
  if (ty < nr) {
    const size_t row_q = ((size_t)b * n + row0 + ty) * ld + h * hd;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int c = 4 * tx + 32 * e + dd;
        if (c < hd) g_qkv[row_q + c] = gq[e][dd];
      }
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mw + g + 8 * (i >> 1), c = nw + 8 * nb + 2 * t4 + (i & 1);
      if (r < nr && c < hd) {
        const size_t o = ((size_t)b * n + row0 + r) * ld + h * hd + c;
        cam_qkv[o] = qkv[o] * cq[nb][i] * 0.5f;
      }
    }
}

// ---------------------------------------------------------------------------
// Column pass: one block of 256 threads per (tile of kColJ = 64 keys j,
// head, sample), over the query rows i streamed in stages of kColI = 32
// through a ring of two shared-memory stages (cp.async: 16-byte pieces
// where the rows allow, else 4-byte; the next stage in flight while the
// block works on this one). A stage holds the rows' P (probs), G (g_raw)
// and S2 at the block's keys, and their g_o, q and S1. It computes
//   g_v = Pᵀ g_o and g_k = Gᵀ q (the gradient products: float32 register
//     micro-tiles, or on bf16 operands (RA), rounded in the stage): warps
//     0–3 g_v, 4–7 g_k; a thread owns keys 4jx … + 3 and columns 4dx … + 3,
//     32 + 4dx … + 3 (three 16-byte reads per 32 FMAs); each output one
//     FMA chain over i ascending;
//   cam_v = v ⊙ (Pᵀ S1) / 2 and cam_k = k ⊙ (S2ᵀ q) / 2 (the rule
//     products). bf16 rules (RR) in float32: on the tensor cores, warp w
//     takes product w / 4, keys 16(w % 4) … + 15 and all 64 columns, 2
//     k-steps a stage. float32 rules (exact FP32, B5 only), and every rule
//     product in double (the checks' instances): register micro-tiles
//     beside the gradient product that shares their operand (warps 0–3 Pᵀ
//     S1 beside Pᵀ g_o, 4–7 S2ᵀ q beside Gᵀ q, the same tile shape; six
//     16-byte reads per 64 FMAs). Where the two products of a warp take
//     their shared operand in different precisions (B5's mixed modes), each
//     rounds it as it is loaded; else the stage is rounded once.
// Sums run in a fixed order (no atomics): bitwise repeatable.
// ---------------------------------------------------------------------------

constexpr int kColJ = 64;                 // keys per block
constexpr int kColI = 32;                 // query rows per stage
constexpr int kColThreads = 256;
constexpr int kLdc = kColJ + 4;           // pitch of the P, G, S2 tiles
constexpr int kColX = kColI * kLdc;       // floats of one P, G or S2 tile
constexpr int kColY = kColI * kLdk;       // floats of one g_o, q or S1 tile
constexpr int kColStage = 3 * kColX + 3 * kColY;

// a tile of the column pass's stage: asynchronous copies in float32, plain
// ones in double where the rows do not allow 16-byte pieces
template <typename T>
__device__ __forceinline__ void col_load(T* dst, int lds, const T* src,
                                         size_t ld, int rows, int cols,
                                         bool vec) {
  if constexpr (sizeof(T) == sizeof(float))
    load_tile_async(dst, lds, src, ld, rows, cols, vec);
  else
    load_tile(dst, lds, src, ld, rows, cols, vec);
}

template <typename T, bool RA, bool RR>
__global__ void __launch_bounds__(kColThreads, sizeof(T) == sizeof(float) ? 2 : 1)
blk_attn_rev_cols_kernel(
    const T* __restrict__ qkv, const T* __restrict__ g_o,
    const T* __restrict__ P, const T* __restrict__ G,
    const T* __restrict__ S2, const T* __restrict__ S1g,
    T* __restrict__ g_qkv, T* __restrict__ cam_qkv, int n, int H, int hd) {
  // the rule products on the tensor cores (bf16 rules in float32)
  constexpr bool MMA = RR && sizeof(T) == sizeof(float);
  // the two products of a warp take their shared operand in different
  // precisions: rounded as loaded, not in the stage
  constexpr bool MIX = RA != RR && !MMA;
  T* smem = reinterpret_cast<T*>(te_smem);   // [2][kColStage]
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int prod = t / 128, jx = t % 16, dx = (t % 128) / 16;
  const int mt = warp % 4, mp = warp / 4;
  const int j0 = blockIdx.x * kColJ, h = blockIdx.y, b = blockIdx.z;
  const int jc = n - j0 < kColJ ? n - j0 : kColJ;
  const int D = H * hd, ld = 3 * D;
  const size_t nn = (size_t)n * n, bh = (size_t)b * H + h;
  const T* maps[3] = {P + bh * nn + j0, G + bh * nn + j0, S2 + bh * nn + j0};
  const T* rows[3] = {g_o + (size_t)b * n * D + h * hd,
                      qkv + (size_t)b * n * ld + h * hd, S1g + bh * n * hd};
  const size_t row_ld[3] = {(size_t)D, (size_t)ld, (size_t)hd};
  const bool vec_x = tile_vec_ok(maps[0], n, jc) &&
                     tile_vec_ok(maps[1], n, jc) &&
                     tile_vec_ok(maps[2], n, jc);
  const bool vec_y = tile_vec_ok(rows[0], D, hd) &&
                     tile_vec_ok(rows[1], ld, hd) &&
                     tile_vec_ok(rows[2], hd, hd);
  const int stages = (n + kColI - 1) / kColI;

  auto fetch = [&](int s) {
    T* st = smem + (s & 1) * kColStage;
    const int i0 = s * kColI, nr = n - i0 < kColI ? n - i0 : kColI;
    // rows past n: zero in every tile (a product over them adds nothing)
    for (int idx = t; idx < 3 * (kColI - nr) * kLdc; idx += kColThreads) {
      const int k = idx / ((kColI - nr) * kLdc), r = idx % ((kColI - nr) * kLdc);
      st[k * kColX + nr * kLdc + r] = T(0);
    }
    for (int idx = t; idx < 3 * (kColI - nr) * kLdk; idx += kColThreads) {
      const int k = idx / ((kColI - nr) * kLdk), r = idx % ((kColI - nr) * kLdk);
      st[3 * kColX + k * kColY + nr * kLdk + r] = T(0);
    }
    for (int k = 0; k < 3; ++k) {
      col_load(st + k * kColX, kLdc, maps[k] + (size_t)i0 * n, n, nr, jc,
               vec_x);
      col_load(st + 3 * kColX + k * kColY, kLdk,
               rows[k] + (size_t)i0 * row_ld[k], row_ld[k], nr, hd, vec_y);
    }
    cp_async_commit();
  };

  T acc[4][8], acc2[4][8];   // the gradient product; the float rule product
  float cm[8][4];            // the bf16 rule product (MMA)
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = acc2[a][e] = T(0);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) cm[nt][i] = 0.f;

  fetch(0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* st = smem + (s & 1) * kColStage;
    if (RA && !MIX) {   // the gradient products take P, G, g_o and q as bf16
      for (int idx = t; idx < kColStage; idx += kColThreads)
        st[idx] = rnd<true>(st[idx]);
      __syncthreads();
    }
    // g_v = Pᵀ g_o (warps 0–3), g_k = Gᵀ q (warps 4–7); beside them, in
    // float32 rules, Pᵀ S1 and S2ᵀ q
    const T* xf = st + prod * kColX + 4 * jx;
    const T* yf = st + 3 * kColX + prod * kColY + 4 * dx;
    const T* xr = st + (prod ? 2 : 0) * kColX + 4 * jx;       // P or S2
    const T* yr = st + 3 * kColX + (prod ? 1 : 2) * kColY + 4 * dx;  // S1 or q
    auto step = [&](int i) {
      T x[4], y0[4], y1[4];
      lds4(xf + i * kLdc, x);
      lds4(yf + i * kLdk, y0);
      lds4(yf + i * kLdk + 32, y1);
      if constexpr (MMA) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[a][e] = fma(x[a], y0[e], acc[a][e]);
            acc[a][4 + e] = fma(x[a], y1[e], acc[a][4 + e]);
          }
      } else {
        T u[4], z0[4], z1[4];
        lds4(xr + i * kLdc, u);
        lds4(yr + i * kLdk, z0);
        lds4(yr + i * kLdk + 32, z1);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          x[a] = rnd<MIX && RA>(x[a]);
          u[a] = rnd<MIX && RR>(u[a]);
          y0[a] = rnd<MIX && RA>(y0[a]);
          y1[a] = rnd<MIX && RA>(y1[a]);
          z0[a] = rnd<MIX && RR>(z0[a]);
          z1[a] = rnd<MIX && RR>(z1[a]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[a][e] = fma(x[a], y0[e], acc[a][e]);
            acc[a][4 + e] = fma(x[a], y1[e], acc[a][4 + e]);
            acc2[a][e] = fma(u[a], z0[e], acc2[a][e]);
            acc2[a][4 + e] = fma(u[a], z1[e], acc2[a][4 + e]);
          }
      }
    };
    if constexpr (sizeof(T) == sizeof(float)) {
#pragma unroll 4
      for (int i = 0; i < kColI; ++i) step(i);
    } else {   // double: fewer live registers
#pragma unroll 1
      for (int i = 0; i < kColI; ++i) step(i);
    }
    if constexpr (MMA) {
      // cam_v's Pᵀ S1 (warps 0–3), cam_k's S2ᵀ q (warps 4–7)
      const float* xm = st + (mp ? 2 : 0) * kColX + 16 * mt + g;
      const float* ym = st + 3 * kColX + (mp ? 1 : 2) * kColY + g;
#pragma unroll
      for (int kk = 0; kk < kColI / 16; ++kk) {
        const float* xa = xm + (16 * kk + 2 * t4) * kLdc;
        const uint32_t af[4] = {pack_bf16x2(xa[0], xa[kLdc]),
                                pack_bf16x2(xa[8], xa[kLdc + 8]),
                                pack_bf16x2(xa[8 * kLdc], xa[9 * kLdc]),
                                pack_bf16x2(xa[8 * kLdc + 8], xa[9 * kLdc + 8])};
        const float* yb = ym + (16 * kk + 2 * t4) * kLdk;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t bf[2] = {pack_bf16x2(yb[8 * nt], yb[8 * nt + kLdk]),
                                  pack_bf16x2(yb[8 * nt + 8 * kLdk],
                                              yb[8 * nt + 9 * kLdk])};
          mma_bf16_16816(cm[nt], af, bf);
        }
      }
    }
    __syncthreads();   // the stage is consumed
  }

  // g_v into the v columns of g_qkv (warps 0–3), g_k into the k columns
  const int part = prod ? D : 2 * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + 4 * jx + a;
    if (j >= n) continue;
    const size_t row = ((size_t)b * n + j) * ld + part + h * hd;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = 4 * dx + (e < 4 ? e : 28 + e);
      if (d < hd) {
        g_qkv[row + d] = acc[a][e];
        if constexpr (!MMA)
          cam_qkv[row + d] = qkv[row + d] * acc2[a][e] * T(0.5);
      }
    }
  }
  if constexpr (MMA) {
    // cam_v = v ⊙ (Pᵀ S1) / 2 (warps 0–3), cam_k = k ⊙ (S2ᵀ q) / 2
    const int mpart = mp ? D : 2 * D;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + 16 * mt + g + 8 * (i >> 1);
        const int d = 8 * nt + 2 * t4 + (i & 1);
        if (j < n && d < hd) {
          const size_t o = ((size_t)b * n + j) * ld + mpart + h * hd + d;
          cam_qkv[o] = qkv[o] * cm[nt][i] * 0.5f;
        }
      }
  }
}

template <typename T>
__global__ void blk_head_mean_kernel(const T* __restrict__ GCP,
                                     T* __restrict__ gc, int B, int H,
                                     size_t nn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nn) return;
  const size_t b = idx / nn, r = idx - b * nn;
  T s = T(0);
  for (int h = 0; h < H; ++h) s += GCP[(b * H + h) * nn + r];
  gc[idx] = s / T(H);
}

// The column pass, then the head mean gc = Σ_h GCP / h, over the batch.
// B3 and B9 run the bf16 rules in float32 (the defaults); B5 every mode
// pair, in float32 and double.
template <bool RA, typename T = float, bool RR = true>
int attn_rev_cols(const T* qkv, const T* g_o, const T* P, const T* G,
                  const T* S2, const T* S1, const T* GCP, T* g_qkv,
                  T* cam_qkv, T* gc, int B, int n, int H, int hd,
                  cudaStream_t stream) {
  const size_t smem = sizeof(T) * 2 * kColStage;
  auto kern = blk_attn_rev_cols_kernel<T, RA, RR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kColJ - 1) / kColJ, H, B);
  TE_LAUNCH(kern, grid, kColThreads, smem, stream)(
      qkv, g_o, P, G, S2, S1, g_qkv, cam_qkv, n, H, hd);
  TE_TRY((int)cudaGetLastError());

  const size_t nn = (size_t)n * n, total = (size_t)B * nn;
  const int threads = 256;
  TE_LAUNCH(blk_head_mean_kernel<T>,
            (unsigned)((total + threads - 1) / threads), threads, 0, stream)(
      GCP, gc, B, H, nn);
  return (int)cudaGetLastError();
}

}  // namespace te
