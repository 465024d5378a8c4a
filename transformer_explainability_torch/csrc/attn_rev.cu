// attn_rev_core: the fused backward + LRP relprop of the attention core.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// attn_rev_core (_attn_rev_kernel), which per (sample, block) loops over
// heads with everything VMEM-resident. Per head it computes
//   forward recompute: dots = q kᵀ (pre-scale), attn = softmax(dots·scale),
//                      out = attn v
//   backward:          g_attn = g_o vᵀ (the attention hook gradient),
//                      g_v = attnᵀ g_o, g_dots = attn ⊙ (g_attn − rowsum(g_attn ⊙ attn)) · scale,
//                      g_q = g_dots k, g_k = g_dotsᵀ q
//   z-rules:           S1 = safe_divide(cam_o, out),
//                      cam1 = attn ⊙ (S1 vᵀ) / 2, cam_v = v ⊙ (attnᵀ S1) / 2,
//                      S2 = safe_divide(cam1, dots)   (pre-scale dots),
//                      cam_q = q ⊙ (S2 k) / 2, cam_k = k ⊙ (S2ᵀ q) / 2
//   gc = mean_h (g_attn ⊙ cam1)⁺
// with g_qkv and cam_qkv in the raw 'n (qkv h d)' layout.
//
// Shapes: qkv (B, n, 3D); g_o, cam_o (B, n, D); out: g_qkv, cam_qkv
// (B, n, 3D), gc (B, n, n). Scratch (allocated by the caller):
// P, G, S2, GCP (B, H, n, n) and S1 (B, H, n, hd).
//
// What bounds it on the H100: a TPU grid step carries the whole head in
// VMEM; here blocks run in parallel with no order and ≤ 227 KB of shared
// memory, and g_v, g_k, cam_v, cam_k are sums over query rows i. So the
// kernel is split in three passes:
//   1. rows: one block per (row tile, head, sample), K and V of the head in
//      shared memory, one warp per query row. It emits g_q and cam_q and
//      writes attn (P), g_dots (G), S2, the per-head (g_attn ⊙ cam1)⁺ (GCP)
//      and S1 to scratch. Bound by shared-memory traffic of scalar loops.
//   2. columns: one block per (column tile, head, sample) runs the four
//      transposed products Pᵀ g_o, Pᵀ S1, Gᵀ q, S2ᵀ q as a tiled product
//      over row tiles. Bound by reading the (B, H, n, n) scratch back:
//      3 · 4 B · n² per head, about 22 MB per ViT-B block at B = 8, which
//      mostly stays in the 50 MB L2.
//   3. head mean: gc = Σ_h GCP / H in a fixed order (no atomics).
// The scratch round trip is the price of the split; keeping tiles of P, G
// and S2 on chip across passes (clusters / distributed shared memory) is
// later work, as are tensor cores.
//
// Modes (the JAX kernel's attn_mxu and rule_mxu): each of the ten products
// takes its operands unrounded (float32 mode) or rounded to bf16 (RA for
// the forward recompute and the gradient products, RR for the four z-rule
// products), with sums in T.
#include "common.cuh"

namespace te {

template <typename T, bool RA, bool RR>
__global__ void attn_rev_rows_kernel(
    const T* __restrict__ qkv, const T* __restrict__ g_o,
    const T* __restrict__ cam_o, T* __restrict__ g_qkv,
    T* __restrict__ cam_qkv, T* __restrict__ P, T* __restrict__ G,
    T* __restrict__ S2, T* __restrict__ GCP, T* __restrict__ S1g, int n,
    int H, int hd, T scale, int rows_per_block) {
  T* smem = reinterpret_cast<T*>(te_smem);
  const int ldk = hd + 1;
  T* Ks = smem;
  T* Vs = Ks + (size_t)n * ldk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  T* qw = Vs + (size_t)n * ldk + (size_t)warp * (3 * hd + 3 * n);
  T* gw = qw + hd;   // g_o row
  T* sw = gw + hd;   // S1 row
  T* ra = sw + hd;   // dots, then S2
  T* rb = ra + n;    // attn
  T* rc = rb + n;    // g_attn, then g_dots

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const T* base = qkv + (size_t)b * n * ld;
  const size_t nn = (size_t)n * n;
  const size_t bh = (size_t)b * H + h;
  const T half = T(0.5);

  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    Ks[j * ldk + d] = base[(size_t)j * ld + D + h * hd + d];
    Vs[j * ldk + d] = base[(size_t)j * ld + 2 * D + h * hd + d];
  }
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  for (int i = row0 + warp; i < row_end; i += nwarps) {
    const size_t row_md = ((size_t)b * n + i) * D + h * hd;  // (B, n, D)
    const size_t row_q = ((size_t)b * n + i) * ld + h * hd;  // (B, n, 3D)
    for (int d = lane; d < hd; d += kWarp) {
      qw[d] = qkv[row_q + d];
      gw[d] = g_o[row_md + d];
    }
    __syncwarp();

    // forward recompute: pre-scale dots, softmax row
    T m = -INFINITY;
    for (int j = lane; j < n; j += kWarp) {
      const T* kr = Ks + j * ldk;
      T s = T(0);
      for (int d = 0; d < hd; ++d)
        s = fma(rnd<RA>(qw[d]), rnd<RA>(kr[d]), s);
      ra[j] = s;
      const T x = s * scale;
      m = x > m ? x : m;
    }
    m = warp_max(m);
    T sum = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T e = exp_t(ra[j] * scale - m);
      rb[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += kWarp) rb[j] = rb[j] / sum;
    __syncwarp();

    // out_i = attn_i V, then S1 = safe_divide(cam_o, out)
    for (int d = lane; d < hd; d += kWarp) {
      T o = T(0);
      for (int j = 0; j < n; ++j)
        o = fma(rnd<RA>(rb[j]), rnd<RA>(Vs[j * ldk + d]), o);
      const T s1 = safe_divide(cam_o[row_md + d], o);
      sw[d] = s1;
      S1g[(bh * n + i) * hd + d] = s1;
    }
    __syncwarp();

    // hook gradient, AV z-rule, QKᵀ denominator, (grad ⊙ cam)⁺
    T inner = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T* vr = Vs + j * ldk;
      T ga = T(0), t = T(0);
      for (int d = 0; d < hd; ++d) {
        ga = fma(rnd<RA>(gw[d]), rnd<RA>(vr[d]), ga);
        t = fma(rnd<RR>(sw[d]), rnd<RR>(vr[d]), t);
      }
      const T a = rb[j];
      inner = fma(ga, a, inner);
      const T cam1 = a * t * half;
      ra[j] = safe_divide(cam1, ra[j]);
      rc[j] = ga;
      const T gcv = ga * cam1;
      GCP[bh * nn + (size_t)i * n + j] = gcv > T(0) ? gcv : T(0);
    }
    inner = warp_sum(inner);
    for (int j = lane; j < n; j += kWarp) {
      const T a = rb[j];
      const T gd = a * (rc[j] - inner) * scale;
      rc[j] = gd;
      const size_t o = bh * nn + (size_t)i * n + j;
      P[o] = a;
      G[o] = gd;
      S2[o] = ra[j];
    }
    __syncwarp();

    // g_q = g_dots K, cam_q = q ⊙ (S2 K) / 2
    for (int d = lane; d < hd; d += kWarp) {
      T gq = T(0), cq = T(0);
      for (int j = 0; j < n; ++j) {
        const T kv = Ks[j * ldk + d];
        gq = fma(rnd<RA>(rc[j]), rnd<RA>(kv), gq);
        cq = fma(rnd<RR>(ra[j]), rnd<RR>(kv), cq);
      }
      g_qkv[row_q + d] = gq;
      cam_qkv[row_q + d] = qw[d] * cq * half;
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

template <typename T, bool RA, bool RR>
__global__ void attn_rev_cols_kernel(
    const T* __restrict__ qkv, const T* __restrict__ g_o,
    const T* __restrict__ P, const T* __restrict__ G,
    const T* __restrict__ S2, const T* __restrict__ S1g,
    T* __restrict__ g_qkv, T* __restrict__ cam_qkv, int n, int H, int hd) {
  T* smem = reinterpret_cast<T*>(te_smem);
  T* Pt = smem;                       // [kRowTile][kColTile]
  T* Gt = Pt + kRowTile * kColTile;
  T* St = Gt + kRowTile * kColTile;
  T* gos = St + kRowTile * kColTile;  // [kRowTile][hd]
  T* qs = gos + kRowTile * hd;
  T* s1s = qs + kRowTile * hd;

  const int t = threadIdx.x;
  const int jl = t / kDGroups, dg = t % kDGroups;
  const int j0 = blockIdx.x * kColTile, h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const size_t nn = (size_t)n * n;
  const size_t bh = (size_t)b * H + h;

  T agv[kMaxDPerThread], acv[kMaxDPerThread];
  T agk[kMaxDPerThread], ack[kMaxDPerThread];
#pragma unroll
  for (int k = 0; k < kMaxDPerThread; ++k) {
    agv[k] = T(0); acv[k] = T(0); agk[k] = T(0); ack[k] = T(0);
  }

  for (int i0 = 0; i0 < n; i0 += kRowTile) {
    __syncthreads();  // the previous stage is consumed
    for (int idx = t; idx < kRowTile * kColTile; idx += blockDim.x) {
      const int i = i0 + idx / kColTile, j = j0 + idx % kColTile;
      const bool ok = i < n && j < n;
      const size_t o = bh * nn + (size_t)i * n + j;
      Pt[idx] = ok ? P[o] : T(0);
      Gt[idx] = ok ? G[o] : T(0);
      St[idx] = ok ? S2[o] : T(0);
    }
    for (int idx = t; idx < kRowTile * hd; idx += blockDim.x) {
      const int i = i0 + idx / hd, d = idx % hd;
      const bool ok = i < n;
      gos[idx] = ok ? g_o[((size_t)b * n + i) * D + h * hd + d] : T(0);
      qs[idx] = ok ? qkv[((size_t)b * n + i) * ld + h * hd + d] : T(0);
      s1s[idx] = ok ? S1g[(bh * n + i) * hd + d] : T(0);
    }
    __syncthreads();
    const int ilim = n - i0 < kRowTile ? n - i0 : kRowTile;
    for (int il = 0; il < ilim; ++il) {
      const T p = Pt[il * kColTile + jl];
      const T g = Gt[il * kColTile + jl];
      const T s = St[il * kColTile + jl];
#pragma unroll
      for (int k = 0; k < kMaxDPerThread; ++k) {
        const int d = dg + kDGroups * k;
        if (d < hd) {
          const T qv = qs[il * hd + d];
          agv[k] = fma(rnd<RA>(p), rnd<RA>(gos[il * hd + d]), agv[k]);
          acv[k] = fma(rnd<RR>(p), rnd<RR>(s1s[il * hd + d]), acv[k]);
          agk[k] = fma(rnd<RA>(g), rnd<RA>(qv), agk[k]);
          ack[k] = fma(rnd<RR>(s), rnd<RR>(qv), ack[k]);
        }
      }
    }
  }

  const int j = j0 + jl;
  if (j >= n) return;
  const size_t row = ((size_t)b * n + j) * ld;
  const T half = T(0.5);
#pragma unroll
  for (int k = 0; k < kMaxDPerThread; ++k) {
    const int d = dg + kDGroups * k;
    if (d < hd) {
      const size_t ck = row + D + h * hd + d, cv = row + 2 * D + h * hd + d;
      g_qkv[ck] = agk[k];
      g_qkv[cv] = agv[k];
      cam_qkv[ck] = qkv[ck] * ack[k] * half;
      cam_qkv[cv] = qkv[cv] * acv[k] * half;
    }
  }
}

template <typename T>
__global__ void head_mean_kernel(const T* __restrict__ GCP, T* __restrict__ gc,
                                 int B, int H, size_t nn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nn) return;
  const size_t b = idx / nn, r = idx - b * nn;
  T s = T(0);
  for (int h = 0; h < H; ++h) s += GCP[(b * H + h) * nn + r];
  gc[idx] = s / T(H);
}

template <typename T, bool RA, bool RR>
int attn_rev_launch(const T* qkv, const T* g_o, const T* cam_o, T* g_qkv,
                    T* cam_qkv, T* gc, T* P, T* G, T* S2, T* GCP, T* S1,
                    int B, int n, int H, int hd, double scale,
                    cudaStream_t stream) {
  if (hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const int limit = max_smem_optin();

  int warps = 8;
  size_t smem_rows = 0;
  for (; warps >= 1; warps /= 2) {
    smem_rows = sizeof(T) * ((size_t)2 * n * (hd + 1) +
                             (size_t)warps * (3 * hd + 3 * n));
    if (smem_rows <= (size_t)limit) break;
  }
  if (warps < 1) return (int)cudaErrorInvalidValue;
  auto rows_kern = attn_rev_rows_kernel<T, RA, RR>;
  cudaError_t err = cudaFuncSetAttribute(
      rows_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  const int rows = 4 * warps;
  dim3 grid_rows((n + rows - 1) / rows, H, B);
  TE_LAUNCH(rows_kern, grid_rows, warps * kWarp, smem_rows, stream)(qkv, g_o, cam_o, g_qkv, cam_qkv, P, G, S2, GCP, S1, n, H,
                    hd, (T)scale, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_cols =
      sizeof(T) * ((size_t)3 * kRowTile * kColTile + (size_t)3 * kRowTile * hd);
  auto cols_kern = attn_rev_cols_kernel<T, RA, RR>;
  err = cudaFuncSetAttribute(
      cols_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cols);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_cols((n + kColTile - 1) / kColTile, H, B);
  TE_LAUNCH(cols_kern, grid_cols, kColThreads, smem_cols, stream)(qkv, g_o, P, G, S2, S1, g_qkv, cam_qkv, n, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t nn = (size_t)n * n, total = (size_t)B * nn;
  const int threads = 256;
  TE_LAUNCH(head_mean_kernel<T>, (unsigned)((total + threads - 1) / threads),
            threads, 0, stream)(GCP, gc, B, H, nn);
  return (int)cudaGetLastError();
}

}  // namespace te

// Plain C entry points. attn_bf16 (the recompute and gradient products) and
// rule_bf16 (the z-rule products): 1 = bf16 operands, 0 = exact.
#define TE_ATTN_REV_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* qkv, const void* g_o, const void* cam_o,    \
                      void* g_qkv, void* cam_qkv, void* gc, void* P, void* G, \
                      void* S2, void* GCP, void* S1, int B, int n, int H,     \
                      int hd, double scale, int attn_bf16, int rule_bf16,     \
                      void* stream) {                                         \
    const auto launch =                                                       \
        attn_bf16 ? (rule_bf16 ? te::attn_rev_launch<T, true, true>           \
                               : te::attn_rev_launch<T, true, false>)         \
                  : (rule_bf16 ? te::attn_rev_launch<T, false, true>          \
                               : te::attn_rev_launch<T, false, false>);       \
    return launch(                                                            \
        static_cast<const T*>(qkv), static_cast<const T*>(g_o),               \
        static_cast<const T*>(cam_o), static_cast<T*>(g_qkv),                 \
        static_cast<T*>(cam_qkv), static_cast<T*>(gc), static_cast<T*>(P),    \
        static_cast<T*>(G), static_cast<T*>(S2), static_cast<T*>(GCP),        \
        static_cast<T*>(S1), B, n, H, hd, scale,                              \
        static_cast<cudaStream_t>(stream));                                   \
  }

TE_ATTN_REV_ENTRY(te_attn_rev_f32, float)
TE_ATTN_REV_ENTRY(te_attn_rev_f64, double)
