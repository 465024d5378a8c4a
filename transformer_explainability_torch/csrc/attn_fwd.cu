// attn_fwd_core: per-head softmax(q kᵀ · scale) v, read straight from the raw
// qkv layout, written back merged.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// attn_fwd_core (_attn_fwd_kernel), which holds one sample's whole (n, 3D)
// qkv in VMEM and loops over heads.
//
// Shapes: qkv (B, n, 3D) with columns in 'n (qkv h d)' order, out (B, n, D),
// D = H·hd, any H, hd <= 64, n up to what shared memory holds (float:
// about 550). One block of 4·QT threads per (tile of QT <= 64 query rows,
// head, sample): 64 rows at ViT-B (4 × H × B blocks).
//
// What bounds it on the H100: operations. At ViT-B, B=8 (n=197, hd=64) the
// two products are 2 · 8·12·197²·64 FMAs = 0.95 GFLOP, 0.0142 ms at the
// 67 TFLOP/s of FP32 off the tensor cores, against 19.4 MB of qkv and out
// (0.0058 ms at 3.35 TB/s). The exact-FP32 mode must stay off the tensor
// cores, so the design is a register-tiled SIMT kernel. A warp's 128-bit
// shared reads are served a quarter-warp at a time, so what limits such a
// kernel is the floats each thread reads per FMA, and the tiles are sized
// for that:
// - the scores are 8 × 8 register tiles (warp w: rows 8w … 8w+7; lane l:
//   keys l + 32c), 16 floats per 64 FMAs; where the row fits in one tile
//   (n <= 256) the softmax runs on them in registers, a warp's 8 rows side
//   by side, so no latency-bound pass over shared memory is left;
// - P·V is 8 × 8 register tiles too; in float32 mode four groups of the
//   threads each take one range of keys, and the groups' sums meet in
//   shared memory and join in a fixed order;
// - Q and K (then V) are copied with 16-byte cp.async; P and V then take
//   the place of Q and K, so two blocks fit an SM (105 KB at ViT-B); warps
//   whose rows lie past n (the last tile at n = 197 holds 5) skip the
//   products.
// Every sum runs in a fixed order, so the kernel is bitwise repeatable.
// The probabilities are formed in a softmax row pass's order (max, exp,
// lane l summing keys l + 32c, the butterfly, then e / Σ). In float32 mode
// P·V sums its key ranges apart; in bf16 mode each output is one chain over
// j = 0 … n−1 in order. B5
// (attn_rev.cu) forms the probabilities again in its own order; nothing
// needs B4 and B5 to agree bitwise.
//
// Modes (the JAX kernel's mxu): float32 products (exact FP32), or bf16
// (RA): q, k, v and the probability row rounded to bf16 as the products
// take them (rounded in shared memory once), float32 sums — the same SIMT
// loops, so no tensor-core accumulation order enters.
#include "common.cuh"

namespace te {

constexpr int kFwdMaxHeadDim = 64;     // as B5 and the other kernels

constexpr int kFwdRegKeys = 8 * kWarp;    // keys whose softmax stays in registers
constexpr int kFwdMaxRows = 64;           // query rows a block

// Shared-memory layout, head widths padded to HD4 = 64 columns.
// Up to 256 keys (reg) the softmax runs in registers and P and V take the
// place of Q and K once the scores are done: [Q | K], then [P | V]. Above,
// Q, one K/V buffer and P lie side by side. (Copying V from the start into a
// region of its own ran slower on the card: one block an SM.)
constexpr int HD4 = kFwdMaxHeadDim;

struct FwdLayout {
  static constexpr int ldk = HD4 + 4;      // ≡ 4 (mod 32): distinct banks
  int n4, ldp;
  bool reg;
  __host__ __device__ explicit FwdLayout(int n) {
    n4 = (n + 3) & ~3;
    ldp = n4 + ((40 - n4 % 32) % 32);      // ≡ 8 (mod 32): distinct banks
    reg = n <= kFwdRegKeys;
  }
  __host__ __device__ size_t p_off(int rows) const {    // in elements
    return reg ? 0 : (size_t)rows * ldk + (size_t)n4 * ldk;
  }
  __host__ __device__ size_t v_off(int rows) const {
    return reg ? (size_t)rows * ldp : (size_t)rows * ldk;
  }
  template <typename T>
  size_t smem(int rows) const {
    const size_t qk = (size_t)rows * ldk + (size_t)n4 * ldk;
    const size_t pv = (size_t)rows * ldp + (size_t)n4 * ldk;
    const size_t all = reg ? (qk > pv ? qk : pv) : qk + (size_t)rows * ldp;
    const size_t parts = (size_t)3 * rows * HD4;   // P·V's group sums
    return sizeof(T) * (all > parts ? all : parts);
  }
};

// zeros in rows rows … rows_pad of a tile and in its columns hd … HD4
template <typename T>
__device__ __forceinline__ void zero_pad(T* s, int ld, int rows, int rows_pad,
                                         int hd, int t, int nt) {
  for (int idx = t; idx < (rows_pad - rows) * HD4; idx += nt)
    s[(rows + idx / HD4) * ld + idx % HD4] = T(0);
  const int w = HD4 - hd;
  for (int idx = t; idx < rows * w; idx += nt)
    s[(idx / w) * ld + hd + idx % w] = T(0);
}

// QT query rows a block (a multiple of 8, at most 64), 4·QT threads, two
// blocks an SM where the shared memory allows. Scores: warp w owns rows 8w
// … 8w+7 and lane l keys l + 32c (c < KC) of each 32·KC-key tile, an 8 × KC
// register tile (16 floats read per 64 FMAs at KC = 8). P·V: four groups
// of the threads each take a range of keys (below).
template <typename T, bool RA, int KC>
__global__ void __launch_bounds__(4 * kFwdMaxRows, 2)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int H,
                int hd, T scale) {
  const int NT = blockDim.x, QT = NT / 4;
  constexpr int ldk = FwdLayout::ldk;
  const FwdLayout lay(n);
  const int n4 = lay.n4, ldp = lay.ldp;
  T* Qs = reinterpret_cast<T*>(te_smem);   // [QT][ldk]
  T* Ks = Qs + QT * ldk;                   // [n4][ldk]
  T* Ps = Qs + lay.p_off(QT);              // [QT][ldp]
  T* Vs = Qs + lay.v_off(QT);              // [n4][ldk]
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp;
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * QT;
  const int nr = n - row0 < QT ? n - row0 : QT;
  // the scores give warp w rows 8w … 8w + 7: the warps past the last row
  // (the last tile at n = 197 holds 5) only help with the copies
  const bool live = 8 * warp < nr;
  const int D = H * hd, ld = 3 * D;
  const T* base = qkv + (size_t)b * n * ld + h * hd;
  const bool vec = tile_vec_ok(base, ld, hd);

  // zeros where the copies do not write: Q rows past n, K/V rows n … n4,
  // the columns hd … HD4
  zero_pad(Qs, ldk, nr, QT, hd, t, NT);
  zero_pad(Ks, ldk, n, n4, hd, t, NT);
  load_tile(Qs, ldk, base + (size_t)row0 * ld, ld, nr, hd, vec);
  load_tile(Ks, ldk, base + D, ld, n, hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (RA) {
    for (int idx = t; idx < (QT + n4) * ldk; idx += NT)
      Qs[idx] = rnd<RA>(Qs[idx]);
    __syncthreads();
  }

  // scores: P[r][j] = (q_r · k_j) · scale
  T acc[8][KC];
  if (live) {
    const T* qp = Qs + 8 * warp * ldk;
    for (int j0 = 0; j0 < n; j0 += kWarp * KC) {
      const T* kp[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = j0 + lane + kWarp * c;
        kp[c] = Ks + (size_t)(j < n ? j : n - 1) * ldk;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][c] = T(0);
      }
#pragma unroll 1   // fewer live registers: ran faster on the card
      for (int d = 0; d < HD4; d += 4) {
        T k[KC][4];
#pragma unroll
        for (int c = 0; c < KC; ++c) lds4(kp[c] + d, k[c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          T q[4];
          lds4(qp + i * ldk + d, q);
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
#pragma unroll
            for (int c = 0; c < KC; ++c)
              acc[i][c] = fma(q[dd], k[c][dd], acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[i][c] = acc[i][c] * scale;
      if (!lay.reg) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = j0 + lane + kWarp * c;
          if (j < n)
#pragma unroll
            for (int i = 0; i < 8; ++i) Ps[(8 * warp + i) * ldp + j] = acc[i][c];
        }
      }
    }
  }
  if (lay.reg) {
    if (live) {
      // the whole row is in the warp's registers: the softmax there, the
      // 8 rows side by side, in the order of the pass below (lane l sums
      // keys l + 32c in ascending c, then the butterfly)
      T m[8], sum[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] = -INFINITY;
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (lane + kWarp * c < n) m[i] = acc[i][c] > m[i] ? acc[i][c] : m[i];
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const T w = __shfl_xor_sync(0xffffffffu, m[i], o);
          m[i] = w > m[i] ? w : m[i];
        }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum[i] = T(0);
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (lane + kWarp * c < n) {
            acc[i][c] = exp_t(acc[i][c] - m[i]);
            sum[i] += acc[i][c];
          }
      }
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
      // e / Σ, not e · (1/Σ): in bf16 mode an ulp here flips the rounding
      // of a probability, and the split path amplifies such flips
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[i][c] = rnd<RA>(acc[i][c] / sum[i]);
    }
    __syncthreads();   // Q and K are consumed: P and V take their place
    if (live) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = lane + kWarp * c;
        if (j < n4)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            Ps[(8 * warp + i) * ldp + j] = j < n ? acc[i][c] : T(0);
      }
    }
    zero_pad(Vs, ldk, n, n4, hd, t, NT);
  } else {
    __syncthreads();
  }

  // V into its buffer; above 256 keys the softmax pass runs meanwhile
  load_tile(Vs, ldk, base + 2 * D, ld, n, hd, vec);
  cp_async_commit();
  for (int r = warp; r < nr && !lay.reg; r += NT / kWarp) {
    T* pr = Ps + r * ldp;
    T m = -INFINITY;
    for (int j = lane; j < n; j += kWarp) m = pr[j] > m ? pr[j] : m;
    m = warp_max(m);
    T sum = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T e = exp_t(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += kWarp) pr[j] = rnd<RA>(pr[j] / sum);
    for (int j = n + lane; j < n4; j += kWarp) pr[j] = T(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (RA) {
    for (int idx = t; idx < n4 * ldk; idx += NT) Vs[idx] = rnd<RA>(Vs[idx]);
    __syncthreads();
  }

  // out[r][c] = Σ_j P[r][j] · v_j[c]: G groups of the threads take one
  // range of keys each; thread u of a group owns rows 8(u/8) … + 7 and
  // columns 4(u%8) + 32e … + 3 (e < 2), an 8 × 8 register tile (16 floats
  // read per 64 FMAs); the groups' sums meet in shared memory and join in
  // group order. float32: 4 groups. bf16 mode: one group, one chain over
  // j = 0 … n−1 per output, as the plain version sums it (the ViT split
  // path rounds this output to bf16, and an ulp of it moved that path's
  // fidelity measurably)
  constexpr int CT = HD4 / 8, G = RA ? 1 : 4;
  const int gsize = NT / G, g = t / gsize, u = t % gsize;
  const int r0 = 8 * (u / CT), c0 = 4 * (u % CT);
  const int jq = ((n4 + G - 1) / G + 3) & ~3;
  const int jb = g * jq < n4 ? g * jq : n4;
  const int je = jb + jq < n4 ? jb + jq : n4;
  const bool live_pv = r0 < nr;
  T o[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) o[i][e][dd] = T(0);
  if (live_pv) {
    const T* pp = Ps + r0 * ldp;
    const T* vp = Vs + c0;
    for (int j = jb; j < je; j += 4) {
      T p[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) lds4(pp + i * ldp + j, p[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          T v[4];
          lds4(vp + (size_t)(j + jj) * ldk + 4 * CT * e, v);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int dd = 0; dd < 4; ++dd)
              o[i][e][dd] = fma(p[i][jj], v[dd], o[i][e][dd]);
        }
    }
  }
  __syncthreads();   // P and V are consumed: the later groups' sums go there
  T* part = Qs;      // [G - 1][QT][HD4]
  if (g > 0 && live_pv)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
          part[((size_t)(g - 1) * QT + r0 + i) * HD4 + c0 + 4 * CT * e + dd] =
              o[i][e][dd];
  __syncthreads();
  if (g > 0 || !live_pv) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (r0 + i >= nr) continue;
    T* orow = out + ((size_t)b * n + row0 + r0 + i) * D + h * hd;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int c = c0 + 4 * CT * e + dd;
        if (c >= hd) continue;
        T s = o[i][e][dd];
        for (int k = 0; k < G - 1; ++k)
          s += part[((size_t)k * QT + r0 + i) * HD4 + c];
        orow[c] = s;
      }
  }
}

// Rows a block: 64 (n rounded up to 8 if less), fewer where the shared
// memory asks (on the card, 40- and 48-row tiles ran slower at ViT-B).
template <typename T, bool RA>
int attn_fwd_launch(const T* qkv, T* out, int B, int n, int H, int hd,
                   double scale, cudaStream_t stream) {
  if (hd < 1 || hd > kFwdMaxHeadDim || n < 1) return (int)cudaErrorInvalidValue;
  const size_t limit = (size_t)max_smem_optin();
  int rows = n < kFwdMaxRows ? (n + 7) & ~7 : kFwdMaxRows;
  const FwdLayout lay(n);
  while (rows > 8 && lay.smem<T>(rows) > limit) rows -= 8;
  const size_t smem = lay.smem<T>(rows);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  // 7 key groups a lane where 224 keys hold the row (ViT-B's 197), else 8
  auto kern = n <= 7 * kWarp ? attn_fwd_kernel<T, RA, 7>
                             : attn_fwd_kernel<T, RA, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(kern, grid, 4 * rows, smem, stream)(qkv, out, n, H, hd,
                                                (T)scale);
  return (int)cudaGetLastError();
}

}  // namespace te

// Plain C entry points. attn_bf16: 1 = bf16 product operands, 0 = exact.
#define TE_ATTN_FWD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* qkv, void* out, int B, int n, int H,       \
                      int hd, double scale, int attn_bf16, void* stream) {   \
    const auto launch = attn_bf16 ? te::attn_fwd_launch<T, true>             \
                                  : te::attn_fwd_launch<T, false>;           \
    return launch(static_cast<const T*>(qkv), static_cast<T*>(out), B, n, H, \
                  hd, scale, static_cast<cudaStream_t>(stream));             \
  }

TE_ATTN_FWD_ENTRY(te_attn_fwd_f32, float)
TE_ATTN_FWD_ENTRY(te_attn_fwd_f64, double)
