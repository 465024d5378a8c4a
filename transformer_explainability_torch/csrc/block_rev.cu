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
// workspace in device memory.
#include "gemm.cuh"

namespace te {

struct EpiStore {
  float* C; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    C[(size_t)r * N + c] = a;
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

__global__ void __launch_bounds__(kAddThreads)
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

__global__ void __launch_bounds__(kAddThreads)
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
int add_rule(const float* a, const float* bpre, const float* bias,
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

__global__ void blk_head_mean_kernel(const float* __restrict__ GCP,
                                     float* __restrict__ gc, int B, int H,
                                     size_t nn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nn) return;
  const size_t b = idx / nn, r = idx - b * nn;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += GCP[(b * H + h) * nn + r];
  gc[idx] = s / (float)H;
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

  const size_t smem_cols = sizeof(float) * ((size_t)3 * kRowTile * kColTile +
                                            (size_t)3 * kRowTile * hd);
  auto cols_kern = blk_attn_rev_cols_kernel<RA, RR>;
  err = cudaFuncSetAttribute(cols_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_cols((n + kColTile - 1) / kColTile, H, B);
  TE_LAUNCH(cols_kern, grid_cols, kColThreads, smem_cols, stream)(
      qkv_pre, bqkv, g_o, probs, G, S2, S1, g_qkv, cam_qkv, n, H, hd);
  TE_TRY((int)cudaGetLastError());

  const size_t nn = (size_t)n * n, total = (size_t)B * nn;
  const int threads = 256;
  TE_LAUNCH(blk_head_mean_kernel, (unsigned)((total + threads - 1) / threads),
            threads, 0, stream)(GCP, gc, B, H, nn);
  return (int)cudaGetLastError();
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
  const size_t rD = (size_t)rows * D, rM = (size_t)rows * M;
  const size_t hnn = (size_t)B * H * n * n;
  Carve ws{work};
  float* xn1 = ws.take<float>(rD);
  float* xn2 = ws.take<float>(rD);
  float* t_M = ws.take<float>(rM);      // g_h1, then the fc1 rule's S
  float* hg = ws.take<float>(rM);
  float* R2 = ws.take<float>(rM);
  float* t_D = ws.take<float>(rD);      // g_xn2, then g_xn1
  float* g_mid = ws.take<float>(rD);
  float* Ca = ws.take<float>(rD);
  float* Cb = ws.take<float>(rD);
  float* Sr = ws.take<float>(rD);
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
  float* partials = ws.take<float>((size_t)B * kAddChunks * 3);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const float scale = (float)pow((double)hd, -0.5);   // as hd ** -0.5
  const uint16_t *q_hi = w.wqkv_hi, *q_lo = w.wqkv_lo;
  const uint16_t *p_hi = w.wproj_hi, *p_lo = w.wproj_lo;

  // MLP half
  TE_TRY(ln_fwd(x_in, w.ln1s, w.ln1b, xn1, rows, D, eps, stream));
  TE_TRY(ln_fwd(x_mid, w.ln2s, w.ln2b, xn2, rows, D, eps, stream));
  TE_TRY(gemm<false, false, false>(
      mlp, GemmArgs{g_out, w.w2_hi, w.w2_lo, D, M, rows, M, D},
      EpiGeluGrad{t_M, hg, sv.fc1_pre, w.b1, M}, stream));
  TE_TRY(gemm<false, false, false>(
      mlp, GemmArgs{t_M, w.w1_hi, w.w1_lo, M, D, rows, D, M},
      EpiStore{t_D, D}, stream));
  TE_TRY(ln_bwd(t_D, x_mid, w.ln2s, g_out, g_mid, rows, D, eps, stream));
  TE_TRY(add_rule(x_mid, sv.fc2_pre, w.b2, R, partials, Ca, Cb, B, n, D,
                  stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{hg, w.w2_hi, w.w2_lo, M, M, rows, D, M},
      EpiRuleDen{Sr, Cb, sv.fc2_pre, D}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{Sr, w.w2_hi, w.w2_lo, D, M, rows, M, D},
      EpiRuleNum{R2, hg, M}, stream));
  TE_TRY(gemm<true, true, false>(
      rule, GemmArgs{xn2, w.w1_hi, w.w1_lo, D, D, rows, M, D},
      EpiRuleDen{t_M, R2, sv.fc1_pre, M}, stream));
  TE_TRY(gemm<false, false, true>(
      rule, GemmArgs{t_M, w.w1_hi, w.w1_lo, M, D, rows, D, M},
      EpiRuleClone{Rm, xn2, Ca, x_mid, D}, stream));

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
