// Pieces of the reverse kernels shared by block_rev.cu (ViT) and
// bert_out_rev.cu / bert_attn_rev.cu (BERT): the GEMM epilogues of the LRP
// rules, the 'ours' add rule with deterministic per-sample sums, and the
// column and head-mean passes of the attention reverse.
#pragma once

#include "gemm.cuh"

namespace te {

struct EpiStore {
  float* C; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    C[(size_t)r * N + c] = a;
  }
};

// out = base + A·B (a backward product joining its residual branch)
struct EpiAdd {
  float* out; const float* base; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    out[o] = base[o] + a;
  }
};

// g_h1 = (g_out·W2) ⊙ gelu′(h1), and hg = gelu(h1), h1 = fc1_pre + b1
struct EpiGeluGrad {
  float* g_h1; float* hg; const float* fc1_pre; const float* b1; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    const float h = fc1_pre[o] + b1[c];
    g_h1[o] = a * gelu_grad(h);
    hg[o] = gelu(h);
  }
};

// the rule's S = safe_divide(R, (y_pre + |x|·|W|ᵀ) / 2)
struct EpiRuleDen {
  float* S; const float* R; const float* y_pre; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    S[o] = safe_divide(R[o], 0.5f * (y_pre[o] + a));
  }
};

// the rule's relevance (x ⊙ S·W + |x| ⊙ S·|W|) / 2
struct EpiRuleNum {
  float* out; const float* x; int N;
  __device__ void operator()(int r, int c, float a, float b) const {
    const size_t o = (size_t)r * N + c;
    const float xv = x[o];
    out[o] = 0.5f * (xv * a + fabsf(xv) * b);
  }
};

// the rule's relevance, then the clone merge with the other branch:
// xc ⊙ safe_divide(R_other + rule, xc)
struct EpiRuleClone {
  float* out; const float* x; const float* R_other; const float* xc; int N;
  __device__ void operator()(int r, int c, float a, float b) const {
    const size_t o = (size_t)r * N + c;
    const float xv = x[o];
    const float rule = 0.5f * (xv * a + fabsf(xv) * b);
    out[o] = xc[o] * safe_divide(R_other[o] + rule, xc[o]);
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

// ---------------------------------------------------------------------------
// The attention reverse's column pass and head mean, from the row pass's
// (B, h, n, n) scratch: P (probs), G (g_dots), S2 (the QKᵀ z-rule's S) and
// the (B, h, n, hd) S1 of the AV z-rule. RA: gradient products in bf16
// (else float32); RR: rule products in bf16 (else float32). q, k, v =
// qkv_pre + bqkv, formed with the forward's own add.
// ---------------------------------------------------------------------------

constexpr int kColTile = 32;   // columns j per block
constexpr int kRowTile = 32;   // rows i per shared-memory stage
constexpr int kDGroups = 8;    // threads per column; thread owns d = dg + 8k
constexpr int kMaxDPerThread = 8;
constexpr int kMaxHeadDim = kDGroups * kMaxDPerThread;   // 64
constexpr int kColThreads = kColTile * kDGroups;         // 256

// columns: g_v = Pᵀ g_o, g_k = Gᵀ q (RA); cam_v = v ⊙ (Pᵀ S1) / 2,
// cam_k = k ⊙ (S2ᵀ q) / 2 (RR), tiled over the rows i
template <bool RA, bool RR>
__global__ void blk_attn_rev_cols_kernel(
    const float* __restrict__ qkv_pre, const float* __restrict__ bqkv,
    const float* __restrict__ g_o, const float* __restrict__ P,
    const float* __restrict__ G, const float* __restrict__ S2,
    const float* __restrict__ S1g, float* __restrict__ g_qkv,
    float* __restrict__ cam_qkv, int n, int H, int hd) {
  float* smem = reinterpret_cast<float*>(te_smem);
  float* Pt = smem;                       // [kRowTile][kColTile]
  float* Gt = Pt + kRowTile * kColTile;
  float* St = Gt + kRowTile * kColTile;
  float* gos = St + kRowTile * kColTile;  // [kRowTile][hd]
  float* qs = gos + kRowTile * hd;
  float* s1s = qs + kRowTile * hd;

  const int t = threadIdx.x;
  const int jl = t / kDGroups, dg = t % kDGroups;
  const int j0 = blockIdx.x * kColTile, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const size_t nn = (size_t)n * n;
  const size_t bh = (size_t)b * H + h;

  float agv[kMaxDPerThread], acv[kMaxDPerThread];
  float agk[kMaxDPerThread], ack[kMaxDPerThread];
#pragma unroll
  for (int k = 0; k < kMaxDPerThread; ++k) {
    agv[k] = 0.f; acv[k] = 0.f; agk[k] = 0.f; ack[k] = 0.f;
  }

  for (int i0 = 0; i0 < n; i0 += kRowTile) {
    __syncthreads();  // the previous stage is consumed
    for (int idx = t; idx < kRowTile * kColTile; idx += blockDim.x) {
      const int i = i0 + idx / kColTile, j = j0 + idx % kColTile;
      const bool ok = i < n && j < n;
      const size_t o = bh * nn + (size_t)i * n + j;
      Pt[idx] = ok ? P[o] : 0.f;
      Gt[idx] = ok ? G[o] : 0.f;
      St[idx] = ok ? S2[o] : 0.f;
    }
    for (int idx = t; idx < kRowTile * hd; idx += blockDim.x) {
      const int i = i0 + idx / hd, d = idx % hd;
      const bool ok = i < n;
      gos[idx] = ok ? g_o[((size_t)b * n + i) * D + h * hd + d] : 0.f;
      qs[idx] = ok ? qkv_pre[((size_t)b * n + i) * ld + h * hd + d] + bqkv[h * hd + d]
                   : 0.f;
      s1s[idx] = ok ? S1g[(bh * n + i) * hd + d] : 0.f;
    }
    __syncthreads();
    const int ilim = n - i0 < kRowTile ? n - i0 : kRowTile;
    for (int il = 0; il < ilim; ++il) {
      const float p = Pt[il * kColTile + jl];
      const float g = Gt[il * kColTile + jl];
      const float s = St[il * kColTile + jl];
#pragma unroll
      for (int k = 0; k < kMaxDPerThread; ++k) {
        const int d = dg + kDGroups * k;
        if (d < hd) {
          const float qv = qs[il * hd + d];
          agv[k] = fmaf(rnd<RA>(p), rnd<RA>(gos[il * hd + d]), agv[k]);
          acv[k] = fmaf(rnd<RR>(p), rnd<RR>(s1s[il * hd + d]), acv[k]);
          agk[k] = fmaf(rnd<RA>(g), rnd<RA>(qv), agk[k]);
          ack[k] = fmaf(rnd<RR>(s), rnd<RR>(qv), ack[k]);
        }
      }
    }
  }

  const int j = j0 + jl;
  if (j >= n) return;
  const size_t row = ((size_t)b * n + j) * ld;
#pragma unroll
  for (int k = 0; k < kMaxDPerThread; ++k) {
    const int d = dg + kDGroups * k;
    if (d < hd) {
      const size_t ck = row + D + h * hd + d, cv = row + 2 * D + h * hd + d;
      g_qkv[ck] = agk[k];
      g_qkv[cv] = agv[k];
      cam_qkv[ck] = (qkv_pre[ck] + bqkv[D + h * hd + d]) * ack[k] * 0.5f;
      cam_qkv[cv] = (qkv_pre[cv] + bqkv[2 * D + h * hd + d]) * acv[k] * 0.5f;
    }
  }
}

static __global__ void blk_head_mean_kernel(const float* __restrict__ GCP,
                                     float* __restrict__ gc, int B, int H,
                                     size_t nn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nn) return;
  const size_t b = idx / nn, r = idx - b * nn;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += GCP[(b * H + h) * nn + r];
  gc[idx] = s / (float)H;
}

// The column pass, then the head mean gc = Σ_h GCP / h, over the batch.
template <bool RA, bool RR>
int attn_rev_cols(const float* qkv_pre, const float* bqkv, const float* g_o,
                  const float* P, const float* G, const float* S2,
                  const float* S1, const float* GCP, float* g_qkv,
                  float* cam_qkv, float* gc, int B, int n, int H, int hd,
                  cudaStream_t stream) {
  const size_t smem_cols = sizeof(float) * ((size_t)3 * kRowTile * kColTile +
                                            (size_t)3 * kRowTile * hd);
  auto cols_kern = blk_attn_rev_cols_kernel<RA, RR>;
  cudaError_t err = cudaFuncSetAttribute(
      cols_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_cols((n + kColTile - 1) / kColTile, H, B);
  TE_LAUNCH(cols_kern, grid_cols, kColThreads, smem_cols, stream)(
      qkv_pre, bqkv, g_o, P, G, S2, S1, g_qkv, cam_qkv, n, H, hd);
  TE_TRY((int)cudaGetLastError());

  const size_t nn = (size_t)n * n, total = (size_t)B * nn;
  const int threads = 256;
  TE_LAUNCH(blk_head_mean_kernel, (unsigned)((total + threads - 1) / threads),
            threads, 0, stream)(GCP, gc, B, H, nn);
  return (int)cudaGetLastError();
}

}  // namespace te
