// The attention forward of one tile of query rows of one head: the scores
// q kᵀ, the softmax and P·V, as register tiles. Shared by B4's kernel
// (attn_fwd.cu), B2's attention core (block_fwd.cu, which also stores the
// pre-scale scores and the probabilities as anchors) and B5's row pass
// (attn_rev.cu, which recomputes the probabilities before its reverse): all
// three form the probabilities by this one function, so they are bitwise
// the same in the three kernels whatever their other tiles.
//
// Design (sized for the H100's FP32 rate off the tensor cores; B4's note in
// attn_fwd.cu says what bounds it):
// - the scores are 8 × KC register tiles (warp w: rows 8w … 8w+7; lane l:
//   keys l + 32c), 16 floats read per 64 FMAs at KC = 8; where the row fits
//   in one tile (n <= 256) the softmax runs on them in registers, a warp's
//   8 rows side by side; above, the scores go to shared memory and a
//   softmax pass runs over them while V is copied;
// - P·V is 8 × 8 register tiles in float32 mode, four groups of the
//   threads each taking one range of keys, the groups' sums meeting in
//   shared memory and joining in a fixed order; in the bf16 modes and the
//   anchor instances (B2, B5) 4 × 4 tiles, each output one chain over
//   j = 0 … n−1;
// - Q and K (then V) are copied with 16-byte cp.async; P and V then take
//   the place of Q and K.
// Every sum runs in a fixed order, so the results are bitwise repeatable.
// The probabilities are formed in a softmax row pass's order (max, exp,
// lane l summing keys l + 32c, the butterfly, then e / Σ).
//
// Modes (the JAX kernel's mxu, common.cuh): float32 products; bf16: q, k,
// v and the probability row rounded to bf16 as the products take them
// (rounded in shared memory once), float32 sums; bf16×3: the operands
// stay unrounded in shared memory and each product runs three passes over
// them (lo·hi, hi·lo, hi·hi), splitting each value as it is loaded, into
// the one accumulator of its output, on the CUDA cores as the other two
// modes (the same loops and tiles, so each output stays one chain; three
// mma.sync passes would change the tiles and the order of every sum).
#pragma once

#include "common.cuh"

namespace te {

constexpr int kFwdMaxHeadDim = 64;     // as B5 and the other kernels

constexpr int kFwdRegKeys = 8 * kWarp;    // keys whose softmax stays in registers
constexpr int kFwdMaxRows = 64;           // query rows a block

// Shared-memory layout, head widths padded to HD4 = 64 columns and the keys
// to n4 rows (a multiple of pad: 4 for B4 and B2, 16 for B5's tensor-core
// steps over keys).
// Up to 256 keys (reg) the softmax runs in registers and P and V take the
// place of Q and K once the scores are done: [Q | K], then [P | V]. Above,
// Q, one K/V buffer and P lie side by side. (Copying V from the start into a
// region of its own ran slower on the card: one block an SM.)
constexpr int HD4 = kFwdMaxHeadDim;

struct FwdLayout {
  static constexpr int ldk = HD4 + 4;      // ≡ 4 (mod 32): distinct banks
  int n4, ldp;
  bool reg;
  __host__ __device__ explicit FwdLayout(int n, int pad = 4) {
    n4 = (n + pad - 1) / pad * pad;
    ldp = n4 + ((40 - n4 % 32) % 32);      // ≡ 8 (mod 32): distinct banks
    reg = n <= kFwdRegKeys;
  }
  __host__ __device__ size_t p_off(int rows) const {    // in elements
    return reg ? 0 : (size_t)rows * ldk + (size_t)n4 * ldk;
  }
  __host__ __device__ size_t v_off(int rows) const {
    return reg ? (size_t)rows * ldp : (size_t)rows * ldk;
  }
  // elements of Q, K, P and V as they overlap
  __host__ __device__ size_t tile(int rows) const {
    const size_t qk = (size_t)rows * ldk + (size_t)n4 * ldk;
    const size_t pv = (size_t)rows * ldp + (size_t)n4 * ldk;
    return reg ? (qk > pv ? qk : pv) : qk + (size_t)rows * ldp;
  }
  template <typename T>
  size_t smem(int rows) const {
    const size_t all = tile(rows);
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

// DS consecutive values from shared memory: one 16-byte read for four
// floats (lds4), else one by one
template <int DS, typename T>
__device__ __forceinline__ void lds_n(const T* p, T (&v)[DS]) {
  if constexpr (DS == 4) {
    lds4(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) v[i] = p[i];
  }
}

// The attention forward of the block's tile: QT = blockDim.x / 4 query rows
// (a multiple of 8, at most 64) from row blockIdx.x · QT of sample
// blockIdx.z, head blockIdx.y, of qkv (B, n, 3·H·hd). smem holds the layout
// lay; part the P·V groups' sums (3·QT·HD4 elements; B4's float32 mode
// only, where it may be smem). With
// ANCH, the pre-scale scores go to dots and the probabilities, before any
// rounding, to probs, both (B, H, n, n) maps (their block offset is formed
// where they are stored, so that no pointer stays live in a register
// across the tile). Each output out[r][c]
// (r < rows in the tile, c < hd) is handed to epi(r, c, value) by the
// thread that formed it. On return V lies at smem + lay.v_off(QT), rounded
// as the products took it; P at smem + lay.p_off(QT) (rows pitch ldp,
// rounded) is consumed; the caller synchronises before it reads either.
//
// Scores: warp w owns rows 8w … 8w+7 and lane l keys l + 32c (c < KC) of
// each 32·KC-key tile, an 8 × KC register tile (16 floats read per 64 FMAs
// at KC = 8). P·V: four groups of the threads each take a range of keys,
// or one chain over the keys per output (below).
template <typename T, int A, int KC, bool ANCH, class Epi>
__device__ __forceinline__ void attn_fwd_tile(
    T* smem, T* part, const FwdLayout& lay, const T* __restrict__ qkv,
    T* __restrict__ dots, T* __restrict__ probs, int n, int H, int hd,
    T scale, const Epi& epi) {
  const int NT = blockDim.x, QT = NT / 4;
  constexpr int ldk = FwdLayout::ldk;
  const int n4 = lay.n4, ldp = lay.ldp;
  T* Qs = smem;                            // [QT][ldk]
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
  // the products' view of their operands: bf16 values lie rounded already
  constexpr int VA = A == kModeBf16x3 ? kModeBf16x3 : kModeF32;

  // zeros where the copies do not write: Q rows past n, K/V rows n … n4,
  // the columns hd … HD4
  zero_pad(Qs, ldk, nr, QT, hd, t, NT);
  zero_pad(Ks, ldk, n, n4, hd, t, NT);
  load_tile(Qs, ldk, base + (size_t)row0 * ld, ld, nr, hd, vec);
  load_tile(Ks, ldk, base + D, ld, n, hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (A == kModeBf16) {
    for (int idx = t; idx < (QT + n4) * ldk; idx += NT)
      Qs[idx] = rnd<true>(Qs[idx]);
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
      // d four at a time in float32 (16-byte reads); two in double, whose
      // K values would not fit the registers four at a time, one in double
      // bf16×3 (its split operands spilled at two; each sum's order is d's)
      constexpr int DS = sizeof(T) == sizeof(float) ? 4
                         : A == kModeBf16x3          ? 1
                                                     : 2;
#pragma unroll 1
      for (int ps = 0; ps < kPasses<A>; ++ps)
#pragma unroll 1   // fewer live registers: ran faster on the card
      for (int d = 0; d < HD4; d += DS) {
        T k[KC][DS];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          lds_n(kp[c] + d, k[c]);
#pragma unroll
          for (int dd = 0; dd < DS; ++dd) k[c][dd] = opnd<VA, 1>(k[c][dd], ps);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          T q[DS];
          lds_n(qp + i * ldk + d, q);
#pragma unroll
          for (int dd = 0; dd < DS; ++dd) q[dd] = opnd<VA, 0>(q[dd], ps);
#pragma unroll
          for (int dd = 0; dd < DS; ++dd)
#pragma unroll
            for (int c = 0; c < KC; ++c)
              acc[i][c] = fma(q[dd], k[c][dd], acc[i][c]);
        }
      }
      if constexpr (ANCH) {
        T* drow = dots + (((size_t)b * H + h) * n + row0 + 8 * warp) * n;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = j0 + lane + kWarp * c;
          if (j < n)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (8 * warp + i < nr) drow[(size_t)i * n + j] = acc[i][c];
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
        for (int c = 0; c < KC; ++c) acc[i][c] = acc[i][c] / sum[i];
      if constexpr (ANCH) {
        T* prow = probs + (((size_t)b * H + h) * n + row0 + 8 * warp) * n;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = lane + kWarp * c;
          if (j < n)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (8 * warp + i < nr) prow[(size_t)i * n + j] = acc[i][c];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[i][c] = rnd<A == kModeBf16>(acc[i][c]);
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
    for (int j = lane; j < n; j += kWarp) {
      const T p = pr[j] / sum;
      if constexpr (ANCH)
        probs[(((size_t)b * H + h) * n + row0 + r) * n + j] = p;
      pr[j] = rnd<A == kModeBf16>(p);
    }
    for (int j = n + lane; j < n4; j += kWarp) pr[j] = T(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (A == kModeBf16) {
    for (int idx = t; idx < n4 * ldk; idx += NT) Vs[idx] = rnd<true>(Vs[idx]);
    __syncthreads();
  }

  // out[r][c] = Σ_j P[r][j] · v_j[c]. In B4's float32 mode four groups of
  // the threads take one range of keys each; thread u of a group owns rows
  // 8(u/8) … + 7 and columns 4(u%8) + 32e … + 3 (e < 2), an 8 × 8 register
  // tile (16 floats read per 64 FMAs); the groups' sums meet in shared
  // memory and join in group order. In the bf16 modes and in the instances
  // that store the anchors (B2, B5) each output is one chain over j = 0 …
  // n−1 (in bf16×3 three such passes, one after the other),
  // as the plain version and the per-row kernels these replaced sum it
  // (the ViT split path rounds this output to bf16, and an ulp of it moved
  // that path's fidelity measurably; B2's out_m feeds the production path,
  // which is ill-conditioned on some inputs; in B5 the chain also ran
  // faster on the card): thread t owns rows 4(t/16) … + 3 and columns
  // 4(t%16) … + 3, a 4 × 4 tile (32 floats read per 64 FMAs).
  if constexpr (A != kModeF32 || ANCH) {
    const int r0 = 4 * (t / 16), c0 = 4 * (t % 16);
    if (r0 >= nr) return;
    T o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) o[i][dd] = T(0);
#pragma unroll 1
    for (int ps = 0; ps < kPasses<A>; ++ps)
    for (int j = 0; j < n4; j += 4) {
      T p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lds4(Ps + (r0 + i) * ldp + j, p[i]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) p[i][jj] = opnd<VA, 0>(p[i][jj], ps);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        T v[4];
        lds4(Vs + (size_t)(j + jj) * ldk + c0, v);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) v[dd] = opnd<VA, 1>(v[dd], ps);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
            o[i][dd] = fma(p[i][jj], v[dd], o[i][dd]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= nr) continue;
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        if (c0 + dd < hd) epi(r0 + i, c0 + dd, o[i][dd]);
    }
    return;
  }
  constexpr int CT = HD4 / 8, G = 4;
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
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int c = c0 + 4 * CT * e + dd;
        if (c >= hd) continue;
        T s = o[i][e][dd];
        for (int k = 0; k < G - 1; ++k)
          s += part[((size_t)k * QT + r0 + i) * HD4 + c];
        epi(r0 + i, c, s);
      }
  }
}

// B4's kernel: QT query rows a block (a multiple of 8, at most 64), 4·QT
// threads, two blocks an SM where the shared memory allows. ANCH: also
// store the pre-scale scores to dots and the probabilities, before any
// rounding, to probs, both (B, H·n, n) (B2's anchors), with P·V in one
// chain per output in both modes: B2's outputs are then bitwise those of
// the per-row core it replaced. (Its registers exceed 128 a thread: one
// block an SM, no spill.)
template <typename T, int A, int KC, bool ANCH>
__global__ void __launch_bounds__(4 * kFwdMaxRows, ANCH ? 1 : 2)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                T* __restrict__ dots, T* __restrict__ probs, int n, int H,
                int hd, T scale) {
  const int QT = blockDim.x / 4, D = H * hd;
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * QT;
  T* orow = out + ((size_t)b * n + row0) * D + h * hd;
  T* smem = reinterpret_cast<T*>(te_smem);
  attn_fwd_tile<T, A, KC, ANCH>(
      smem, smem, FwdLayout(n), qkv, dots, probs, n, H, hd, scale,
      [&](int r, int c, T s) { orow[(size_t)r * D + c] = s; });
}

// Rows a block: 64 (n rounded up to 8 if less), fewer where the shared
// memory asks (on the card, 40- and 48-row tiles ran slower at ViT-B).
template <typename T, int A, bool ANCH = false>
int attn_fwd_launch(const T* qkv, T* out, T* dots, T* probs, int B, int n,
                    int H, int hd, double scale, cudaStream_t stream) {
  if (hd < 1 || hd > kFwdMaxHeadDim || n < 1) return (int)cudaErrorInvalidValue;
  const size_t limit = (size_t)max_smem_optin();
  int rows = n < kFwdMaxRows ? (n + 7) & ~7 : kFwdMaxRows;
  const FwdLayout lay(n);
  while (rows > 8 && lay.smem<T>(rows) > limit) rows -= 8;
  const size_t smem = lay.smem<T>(rows);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  // 7 key groups a lane where 224 keys hold the row (ViT-B's 197), else 8
  auto kern = n <= 7 * kWarp ? attn_fwd_kernel<T, A, 7, ANCH>
                             : attn_fwd_kernel<T, A, 8, ANCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(kern, grid, 4 * rows, smem, stream)(qkv, out, dots, probs, n, H,
                                                hd, (T)scale);
  return (int)cudaGetLastError();
}

}  // namespace te
