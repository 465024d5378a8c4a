// The one hand-written GEMM core of the block kernels (block_fwd.cu,
// block_rev.cu): C = A·B with float32 activations A and bf16 weight planes
// B, on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators), with a fused elementwise epilogue.
//
// It computes what _kdot of transformer_explainability_tpu/ops/
// pallas_kernels.py computes for an activation times a prepared weight:
//   kBf16:   bf16(A)·hi                          (one pass)
//   kBf16x3: hi(A)·hi + (hi(A)·lo + lo(A)·hi)    (three passes, two
//            accumulators, associated as JAX associates)
// where A = hi(A) + lo(A) is split on load with round-to-nearest-even and
// the weight W = hi + lo arrives split once per model (ops/precision.py).
//
// Shapes: A (M, K) row-major float32 with row pitch lda. W is an nn.Linear
// weight (out, in) row-major with pitch ldw; B = Wᵀ (WT = true: k is W's
// column, the forward products x·Wᵀ) or B = W (WT = false: k is W's row,
// the backward and rule products g·W). ABS multiplies |A| by |W| with the
// split's abs (|hi|, sign(hi)·lo) (JAX _kabs); DUAL returns A·W and A·|W|
// from one A operand (each α-β rule needs both). The epilogue gets
// (row, col, A·B, A·|B|) for every element of C inside (M, N).
//
// Tiling: 64×64 output tiles, k-steps of 32, 8 warps as 4 (rows) × 2
// (columns) of 16×32 each. A and B are staged through two shared-memory
// stages as bf16 with k contiguous (B is transposed on the way when WT is
// false), rows padded to 40 elements so that the fragment reads are free of
// bank conflicts; the next k-step's global loads (16-byte vectors) sit in
// registers while the tensor cores work on the current stage.
// What bounds it on the H100: the staging work per k-step (the float32 ->
// bf16 split of A, the B transpose) and one barrier per 8 (bf16) to 24
// (bf16×3, dual) mma per warp; cp.async/TMA pipelines and wgmma are later
// work. Ragged M is masked by zero fill; K and N are multiples of 8.
#pragma once

#include "common.cuh"

namespace te {

enum GemmMode { kBf16 = 0, kBf16x3 = 1 };

constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kGemmLd = kGemmBK + 8;
constexpr int kGemmSmem = 2 * 2 * (kGemmBM + kGemmBN) * kGemmLd * 2;   // bytes

struct GemmArgs {
  const float* A;
  const uint16_t* Whi;
  const uint16_t* Wlo;   // may be null in kBf16 mode
  int lda, ldw, M, N, K;
};

// |hi + lo| as (|hi|, sign(hi)·lo) on two packed bf16 pairs
__device__ __forceinline__ void kabs_pair(uint32_t hi, uint32_t lo,
                                          uint32_t& ahi, uint32_t& alo) {
  uint32_t flip = 0;
  if ((hi & 0x8000u) && (hi & 0x7FFFu)) flip |= 0x8000u;
  if ((hi & 0x80000000u) && (hi & 0x7FFF0000u)) flip |= 0x80000000u;
  ahi = hi & 0x7FFF7FFFu;
  alo = lo ^ flip;
}

// The global loads of one k-step, held in registers while the tensor cores
// work on the previous one: A as 2 float4 per thread (rows of 8 float4), B
// as one 8-wide bf16 vector per plane (along k when WT, along n otherwise).
struct GemmFetch {
  float4 a[2];
  uint4 bh, bl;
};

template <bool WT, bool X3>
__device__ __forceinline__ void gemm_fetch(const GemmArgs& g, int m0, int n0,
                                           int k0, int t, GemmFetch& f) {
  const float4 fz = {0.f, 0.f, 0.f, 0.f};
  const uint4 uz = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = t + i * kGemmThreads;
    const int row = m0 + idx / 8, k = k0 + 4 * (idx % 8);
    f.a[i] = (row < g.M && k < g.K)
                 ? *reinterpret_cast<const float4*>(g.A + (size_t)row * g.lda + k)
                 : fz;
  }
  size_t o;
  bool ok;
  if constexpr (WT) {          // 64 n × (4 × 8 k)
    const int col = n0 + t / 4, k = k0 + 8 * (t % 4);
    ok = col < g.N && k < g.K;
    o = (size_t)col * g.ldw + k;
  } else {                     // 32 k × (8 × 8 n)
    const int k = k0 + t / 8, col = n0 + 8 * (t % 8);
    ok = col < g.N && k < g.K;
    o = (size_t)k * g.ldw + col;
  }
  f.bh = ok ? *reinterpret_cast<const uint4*>(g.Whi + o) : uz;
  if constexpr (X3) f.bl = ok ? *reinterpret_cast<const uint4*>(g.Wlo + o) : uz;
}

// registers -> one shared-memory stage: A split to (hi, lo) bf16, B as
// [n][k]; ABS takes |A| and the split's abs of B
template <bool WT, bool ABS, bool X3>
__device__ __forceinline__ void gemm_stage(const GemmFetch& f, int t,
                                           uint16_t* As0, uint16_t* As1,
                                           uint16_t* Bs0, uint16_t* Bs1) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = t + i * kGemmThreads;
    const int r = idx / 8, c = 4 * (idx % 8);
    const float v4[4] = {f.a[i].x, f.a[i].y, f.a[i].z, f.a[i].w};
    uint16_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = ABS ? fabsf(v4[e]) : v4[e];
      hi[e] = f2bf(v);
      lo[e] = X3 ? f2bf(v - bf2f(hi[e])) : uint16_t(0);
    }
    uint2 h2, l2;
    h2.x = hi[0] | (uint32_t)hi[1] << 16;
    h2.y = hi[2] | (uint32_t)hi[3] << 16;
    *reinterpret_cast<uint2*>(As0 + r * kGemmLd + c) = h2;
    if constexpr (X3) {
      l2.x = lo[0] | (uint32_t)lo[1] << 16;
      l2.y = lo[2] | (uint32_t)lo[3] << 16;
      *reinterpret_cast<uint2*>(As1 + r * kGemmLd + c) = l2;
    }
  }
  uint32_t bh[4] = {f.bh.x, f.bh.y, f.bh.z, f.bh.w};
  uint32_t bl[4] = {0u, 0u, 0u, 0u};
  if constexpr (X3) {
    bl[0] = f.bl.x; bl[1] = f.bl.y; bl[2] = f.bl.z; bl[3] = f.bl.w;
  }
  if constexpr (ABS) {
#pragma unroll
    for (int e = 0; e < 4; ++e) kabs_pair(bh[e], bl[e], bh[e], bl[e]);
  }
  if constexpr (WT) {
    const int n = t / 4, c = 8 * (t % 4);
    *reinterpret_cast<uint4*>(Bs0 + n * kGemmLd + c) =
        uint4{bh[0], bh[1], bh[2], bh[3]};
    if constexpr (X3)
      *reinterpret_cast<uint4*>(Bs1 + n * kGemmLd + c) =
          uint4{bl[0], bl[1], bl[2], bl[3]};
  } else {
    const int c = t / 8, n = 8 * (t % 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      Bs0[(n + e) * kGemmLd + c] = (uint16_t)(bh[e / 2] >> (16 * (e % 2)));
      if constexpr (X3)
        Bs1[(n + e) * kGemmLd + c] = (uint16_t)(bl[e / 2] >> (16 * (e % 2)));
    }
  }
}

template <int MODE, bool WT, bool ABS, bool DUAL, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(GemmArgs g, Epi epi) {
  constexpr bool X3 = MODE == kBf16x3;
  // dynamic shared memory: two stages of (A hi, A lo, B hi, B lo)
  uint16_t* const sm = reinterpret_cast<uint16_t*>(te_smem);
  constexpr int kA = kGemmBM * kGemmLd, kB = kGemmBN * kGemmLd;
  constexpr int kStage = 2 * (kA + kB);

  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp;
  const int wm = warp % 4, wn = warp / 4;
  const int gi = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;

  constexpr int NS = (DUAL ? 2 : 1) * (X3 ? 2 : 1);
  float acc[NS][4][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][j][i] = 0.f;

  GemmFetch f;
  gemm_fetch<WT, X3>(g, m0, n0, 0, t, f);
  gemm_stage<WT, ABS, X3>(f, t, sm, sm + kA, sm + 2 * kA, sm + 2 * kA + kB);
  __syncthreads();

  const int nk = (g.K + kGemmBK - 1) / kGemmBK;
  for (int kt = 0; kt < nk; ++kt) {
    const uint16_t* st = sm + (kt & 1) * kStage;
    const uint16_t* As[2] = {st, st + kA};
    const uint16_t* Bs[2] = {st + 2 * kA, st + 2 * kA + kB};
    // the next k-step's loads are in flight while this one computes
    if (kt + 1 < nk) gemm_fetch<WT, X3>(g, m0, n0, (kt + 1) * kGemmBK, t, f);

#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      uint32_t a[2][4];
      const int r0 = wm * 16 + gi;
#pragma unroll
      for (int p = 0; p < (X3 ? 2 : 1); ++p) {
        const uint16_t* base = As[p];
        a[p][0] = *reinterpret_cast<const uint32_t*>(base + r0 * kGemmLd + kk + 2 * t4);
        a[p][1] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * kGemmLd + kk + 2 * t4);
        a[p][2] = *reinterpret_cast<const uint32_t*>(base + r0 * kGemmLd + kk + 8 + 2 * t4);
        a[p][3] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * kGemmLd + kk + 8 + 2 * t4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + gi;
        uint32_t bh[2], bl[2] = {0u, 0u};
        bh[0] = *reinterpret_cast<const uint32_t*>(Bs[0] + n * kGemmLd + kk + 2 * t4);
        bh[1] = *reinterpret_cast<const uint32_t*>(Bs[0] + n * kGemmLd + kk + 8 + 2 * t4);
        if constexpr (X3) {
          bl[0] = *reinterpret_cast<const uint32_t*>(Bs[1] + n * kGemmLd + kk + 2 * t4);
          bl[1] = *reinterpret_cast<const uint32_t*>(Bs[1] + n * kGemmLd + kk + 8 + 2 * t4);
        }
        // set 0: hi·hi; set 1 (x3): hi·lo + lo·hi
        mma_bf16_16816(acc[0][j], a[0], bh);
        if constexpr (X3) {
          mma_bf16_16816(acc[1][j], a[0], bl);
          mma_bf16_16816(acc[1][j], a[1], bh);
        }
        if constexpr (DUAL) {
          uint32_t ah[2], al[2];
          kabs_pair(bh[0], bl[0], ah[0], al[0]);
          kabs_pair(bh[1], bl[1], ah[1], al[1]);
          constexpr int s = X3 ? 2 : 1;
          mma_bf16_16816(acc[s][j], a[0], ah);
          if constexpr (X3) {
            mma_bf16_16816(acc[s + 1][j], a[0], al);
            mma_bf16_16816(acc[s + 1][j], a[1], ah);
          }
        }
      }
    }
    // the other stage was last read before the previous barrier
    if (kt + 1 < nk) {
      uint16_t* nx = sm + ((kt + 1) & 1) * kStage;
      gemm_stage<WT, ABS, X3>(f, t, nx, nx + kA, nx + 2 * kA, nx + 2 * kA + kB);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm * 16 + gi + 8 * (i >> 1);
      const int col = n0 + wn * 32 + j * 8 + 2 * t4 + (i & 1);
      if (row >= g.M || col >= g.N) continue;
      float v = acc[0][j][i];
      if constexpr (X3) v += acc[1][j][i];
      float w = 0.f;
      if constexpr (DUAL && X3) w = acc[2][j][i] + acc[3][j][i];
      else if constexpr (DUAL) w = acc[1][j][i];
      epi(row, col, v, w);
    }
  }
}

// Launch in the mode the caller names; kBf16x3 needs the lo plane. The
// vector loads need K and N multiples of 8, lda of 4 and ldw of 8.
template <bool WT, bool ABS, bool DUAL, class Epi>
int gemm(int mode, const GemmArgs& g, const Epi& epi, cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return (int)cudaSuccess;
  if (g.K % 8 || g.N % 8 || g.lda % 4 || g.ldw % 8)
    return (int)cudaErrorInvalidValue;
  dim3 grid((g.N + kGemmBN - 1) / kGemmBN, (g.M + kGemmBM - 1) / kGemmBM);
  if (mode == kBf16) {
    auto kern = gemm_kernel<kBf16, WT, ABS, DUAL, Epi>;
    TE_LAUNCH(kern, grid, kGemmThreads, kGemmSmem, stream)(g, epi);
  } else if (mode == kBf16x3 && g.Wlo != nullptr) {
    auto kern = gemm_kernel<kBf16x3, WT, ABS, DUAL, Epi>;
    TE_LAUNCH(kern, grid, kGemmThreads, kGemmSmem, stream)(g, epi);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row kernels and elementwise pieces shared by the forward and the reverse
// kernel. The forward and the reverse call the same compiled functions on
// the same values, so every anchor a rule divides by is bitwise the value
// its numerator was linearised at.
// ---------------------------------------------------------------------------

constexpr float kSqrt2 = 1.41421356237309504880f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

// an operand as a product of precision R takes it: bf16 (R) or float32
template <bool R>
__device__ __forceinline__ float rnd(float x) { return R ? round_bf16(x) : x; }

// JAX _gelu_exact with erff
__device__ __forceinline__ float gelu(float x) {
  return mul_rn(x, mul_rn(0.5f, add_rn(1.0f, erff(x / kSqrt2))));
}

// JAX _gelu_grad: Φ(x) + x·φ(x)
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x / kSqrt2));
  const float pdf = expf(-0.5f * x * x) * kInvSqrt2Pi;
  return cdf + x * pdf;
}

// mean and 1/sqrt(var + eps) of one row, one warp per row (lane-strided
// sums, butterfly reduction: a fixed order)
__device__ __forceinline__ void ln_stats(const float* x, int D, float eps,
                                         int lane, float& mu, float& inv) {
  float s = 0.f;
  for (int c = lane; c < D; c += kWarp) s += x[c];
  mu = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int c = lane; c < D; c += kWarp) {
    const float d = x[c] - mu;
    v += d * d;
  }
  inv = 1.0f / sqrtf(warp_sum(v) / (float)D + eps);
}

constexpr int kRowWarps = 8;

// xn = (x − μ)·inv·s + b (JAX _ln_fwd), rows of width D
static __global__ void __launch_bounds__(kRowWarps * kWarp)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ b, float* __restrict__ xn, int rows,
              int D, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * D;
  float mu, inv;
  ln_stats(xr, D, eps, lane, mu, inv);
  for (int c = lane; c < D; c += kWarp)
    xn[(size_t)row * D + c] =
        add_rn(mul_rn(mul_rn(xr[c] - mu, inv), s[c]), b[c]);
}

// out = g_res + LayerNorm backward of g (JAX _block_rev_math's LN tails)
static __global__ void __launch_bounds__(kRowWarps * kWarp)
ln_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ s, const float* __restrict__ g_res,
              float* __restrict__ out, int rows, int D, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  float mu, inv;
  ln_stats(x + o, D, eps, lane, mu, inv);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += kWarp) {
    const float gg = g[o + c] * s[c];
    s1 += gg;
    s2 += gg * ((x[o + c] - mu) * inv);
  }
  const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
  for (int c = lane; c < D; c += kWarp) {
    const float gg = g[o + c] * s[c];
    const float xhat = (x[o + c] - mu) * inv;
    out[o + c] = g_res[o + c] + inv * (gg - m1 - xhat * m2);
  }
}

inline int ln_fwd(const float* x, const float* s, const float* b, float* xn,
                  int rows, int D, float eps, cudaStream_t stream) {
  TE_LAUNCH(ln_fwd_kernel, (rows + kRowWarps - 1) / kRowWarps,
            kRowWarps * kWarp, 0, stream)(x, s, b, xn, rows, D, eps);
  return (int)cudaGetLastError();
}

inline int ln_bwd(const float* g, const float* x, const float* s,
                  const float* g_res, float* out, int rows, int D, float eps,
                  cudaStream_t stream) {
  TE_LAUNCH(ln_bwd_kernel, (rows + kRowWarps - 1) / kRowWarps,
            kRowWarps * kWarp, 0, stream)(g, x, s, g_res, out, rows, D, eps);
  return (int)cudaGetLastError();
}

// One block's parameters: LayerNorm scales and biases and Linear biases in
// float32, the four weights as bf16 (hi, lo) planes in the nn.Linear layout
// (out, in); a lo plane is null where the weights are prepared for bf16.
struct BlockWeights {
  const float *ln1s, *ln1b, *ln2s, *ln2b, *bqkv, *bproj, *b1, *b2;
  const uint16_t *wqkv_hi, *wqkv_lo, *wproj_hi, *wproj_lo;
  const uint16_t *w1_hi, *w1_lo, *w2_hi, *w2_lo;
};

// Bump allocator over one workspace (a null base only measures it).
struct Carve {
  char* base;
  size_t used = 0;
  template <typename T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * sizeof(T) + 255) & ~(size_t)255;
    return p;
  }
};

// return a non-zero error code at once (variadic: template commas)
#define TE_TRY(...)                       \
  do {                                    \
    const int te_err_ = (__VA_ARGS__);    \
    if (te_err_ != 0) return te_err_;     \
  } while (0)

}  // namespace te
