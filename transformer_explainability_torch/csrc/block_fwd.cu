// block_fwd_core: one whole ViT block forward, with the rich anchors.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// block_fwd_core (_block_fwd_kernel / _block_fwd_math), which runs a block
// per (sample, block) in one Pallas program with all weights in VMEM:
//   xn1 = LN1(x); qkv_pre = xn1·Wqkvᵀ (mxu); qkv = qkv_pre + bqkv
//   per head: dots = q·kᵀ (attn_mxu, pre-scale), probs = softmax(dots·scale),
//             out_m = probs·v (attn_mxu)
//   proj_pre = out_m·Wprojᵀ (mxu); x_mid = x + (proj_pre + bproj)
//   xn2 = LN2(x_mid); fc1_pre = xn2·W1ᵀ (mlp); hg = gelu(fc1_pre + b1)
//   fc2_pre = hg·W2ᵀ (mlp); x_out = x_mid + (fc2_pre + b2)
// and saves x_mid, out_m and the rich anchors qkv_pre, proj_pre, dots,
// probs (B, h·n, n), fc1_pre, fc2_pre for block_rev_core.
//
// What bounds it on the H100: one sample's weights (14 MB as bf16 pairs) do
// not fit in a block's 227 KB of shared memory, and the (n, M) GELU
// activations do not either. So the block is split into launches over the
// whole batch (B·n rows share each weight read): LN1, the qkv GEMM, the
// attention core per (row tile, head, sample), the proj GEMM, LN2, the fc1
// GEMM with GELU in its epilogue, the fc2 GEMM; intermediates go through a
// workspace in device memory (mostly L2-resident at B=8). The four GEMMs
// (gemm.cuh) run on the tensor cores; the attention core is scalar FP32 from
// shared memory as in attn_fwd.cu, with the operands rounded to bf16 when
// attn_mxu is bfloat16.
#include "gemm.cuh"

namespace te {

// qkv GEMM: qkv_pre, and qkv = qkv_pre + bqkv for the attention core
struct EpiQkv {
  float* pre; float* biased; const float* bias; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    pre[o] = a;
    biased[o] = a + bias[c];
  }
};

// proj / fc2 GEMMs: the pre-bias product, and out = res + (pre + bias)
struct EpiResidual {
  float* pre; float* out; const float* res; const float* bias; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    pre[o] = a;
    out[o] = res[o] + (a + bias[c]);
  }
};

// fc1 GEMM: fc1_pre, and hg = gelu(fc1_pre + b1) for the fc2 GEMM
struct EpiGelu {
  float* pre; float* hg; const float* bias; int N;
  __device__ void operator()(int r, int c, float a, float) const {
    const size_t o = (size_t)r * N + c;
    pre[o] = a;
    hg[o] = gelu(a + bias[c]);
  }
};

// One block per (row tile, head, sample); K and V of the head (rounded as
// the products take them) in shared memory; one warp per query row.
template <bool RA>
__global__ void blk_attn_fwd_kernel(const float* __restrict__ qkv,
                                    float* __restrict__ dots,
                                    float* __restrict__ probs,
                                    float* __restrict__ out, int n, int H,
                                    int hd, float scale, int rows_per_block) {
  float* smem = reinterpret_cast<float*>(te_smem);
  const int ldk = hd + 1;
  float* Ks = smem;
  float* Vs = Ks + (size_t)n * ldk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* qw = Vs + (size_t)n * ldk + (size_t)warp * (hd + n);
  float* pw = qw + hd;

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv + (size_t)b * n * ld;
  const size_t bh = (size_t)b * H + h;

  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    Ks[j * ldk + d] = rnd<RA>(base[(size_t)j * ld + D + h * hd + d]);
    Vs[j * ldk + d] = rnd<RA>(base[(size_t)j * ld + 2 * D + h * hd + d]);
  }
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  for (int i = row0 + warp; i < row_end; i += nwarps) {
    const float* qrow = base + (size_t)i * ld + h * hd;
    for (int d = lane; d < hd; d += kWarp) qw[d] = rnd<RA>(qrow[d]);
    __syncwarp();

    float* drow = dots + (bh * n + i) * n;
    float* prow = probs + (bh * n + i) * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += kWarp) {
      const float* kr = Ks + j * ldk;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qw[d], kr[d], s);
      drow[j] = s;
      s = s * scale;
      pw[j] = s;
      m = s > m ? s : m;
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += kWarp) {
      const float e = expf(pw[j] - m);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += kWarp) {
      const float p = pw[j] / sum;
      prow[j] = p;
      pw[j] = rnd<RA>(p);
    }
    __syncwarp();

    float* orow = out + ((size_t)b * n + i) * D + h * hd;
    for (int d = lane; d < hd; d += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(pw[j], Vs[j * ldk + d], acc);
      orow[d] = acc;
    }
    __syncwarp();  // the next row overwrites qw and pw
  }
}

template <bool RA>
int blk_attn_fwd(const float* qkv, float* dots, float* probs, float* out,
                 int B, int n, int H, int hd, float scale,
                 cudaStream_t stream) {
  const int limit = max_smem_optin();
  int warps = 8;
  size_t smem = 0;
  for (; warps >= 1; warps /= 2) {
    smem = sizeof(float) * ((size_t)2 * n * (hd + 1) + (size_t)warps * (hd + n));
    if (smem <= (size_t)limit) break;
  }
  if (warps < 1) return (int)cudaErrorInvalidValue;
  auto kern = blk_attn_fwd_kernel<RA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 4 * warps;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(kern, grid, warps * kWarp, smem, stream)(qkv, dots, probs, out, n,
                                                     H, hd, scale, rows);
  return (int)cudaGetLastError();
}

int block_fwd(const float* x, const BlockWeights& w, float* x_out,
              float* x_mid, float* out_m, float* qkv_pre, float* proj_pre,
              float* dots, float* probs, float* fc1_pre, float* fc2_pre,
              char* work, size_t* work_bytes, int B, int n, int H, int hd,
              int M, float eps, int mxu, int attn_bf16, int mlp,
              cudaStream_t stream) {
  const int D = H * hd, rows = B * n;
  Carve ws{work};
  float* xn = ws.take<float>((size_t)rows * D);
  float* qkv = ws.take<float>((size_t)rows * 3 * D);
  float* hg = ws.take<float>((size_t)rows * M);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const float scale = (float)pow((double)hd, -0.5);   // as hd ** -0.5

  TE_TRY(ln_fwd(x, w.ln1s, w.ln1b, xn, rows, D, eps, stream));
  TE_TRY(gemm<true, false, false>(
      mxu, GemmArgs{xn, w.wqkv_hi, w.wqkv_lo, D, D, rows, 3 * D, D},
      EpiQkv{qkv_pre, qkv, w.bqkv, 3 * D}, stream));
  TE_TRY(attn_bf16 ? blk_attn_fwd<true>(qkv, dots, probs, out_m, B, n, H, hd,
                                        scale, stream)
                   : blk_attn_fwd<false>(qkv, dots, probs, out_m, B, n, H, hd,
                                         scale, stream));
  TE_TRY(gemm<true, false, false>(
      mxu, GemmArgs{out_m, w.wproj_hi, w.wproj_lo, D, D, rows, D, D},
      EpiResidual{proj_pre, x_mid, x, w.bproj, D}, stream));
  TE_TRY(ln_fwd(x_mid, w.ln2s, w.ln2b, xn, rows, D, eps, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{xn, w.w1_hi, w.w1_lo, D, D, rows, M, D},
      EpiGelu{fc1_pre, hg, w.b1, M}, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{hg, w.w2_hi, w.w2_lo, M, M, rows, D, M},
      EpiResidual{fc2_pre, x_out, x_mid, w.b2, D}, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x; ln1s, ln1b, ln2s, ln2b, bqkv,
// bproj, b1, b2; the weight planes (hi, lo) of qkv, proj, fc1, fc2 (lo may be
// null for one-pass modes); the outputs x_out, x_mid, out_m, qkv_pre,
// proj_pre, dots, probs, fc1_pre, fc2_pre; the workspace. With a null
// workspace it only writes the workspace size to *work_bytes. Modes: mxu and
// mlp 0 = bf16, 1 = bf16×3; attn_bf16 1 = bf16 operands, 0 = float32.
extern "C" int te_block_fwd_f32(
    const void* x, const void* ln1s, const void* ln1b, const void* ln2s,
    const void* ln2b, const void* bqkv, const void* bproj, const void* b1,
    const void* b2, const void* wqkv_hi, const void* wqkv_lo,
    const void* wproj_hi, const void* wproj_lo, const void* w1_hi,
    const void* w1_lo, const void* w2_hi, const void* w2_lo, void* x_out,
    void* x_mid, void* out_m, void* qkv_pre, void* proj_pre, void* dots,
    void* probs, void* fc1_pre, void* fc2_pre, void* work, void* work_bytes,
    int B, int n, int H, int hd, int M, double eps, int mxu, int attn_bf16,
    int mlp, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{
      static_cast<F>(ln1s), static_cast<F>(ln1b), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(bqkv), static_cast<F>(bproj),
      static_cast<F>(b1), static_cast<F>(b2), static_cast<W>(wqkv_hi),
      static_cast<W>(wqkv_lo), static_cast<W>(wproj_hi),
      static_cast<W>(wproj_lo), static_cast<W>(w1_hi), static_cast<W>(w1_lo),
      static_cast<W>(w2_hi), static_cast<W>(w2_lo)};
  return te::block_fwd(
      static_cast<F>(x), w, static_cast<float*>(x_out),
      static_cast<float*>(x_mid), static_cast<float*>(out_m),
      static_cast<float*>(qkv_pre), static_cast<float*>(proj_pre),
      static_cast<float*>(dots), static_cast<float*>(probs),
      static_cast<float*>(fc1_pre), static_cast<float*>(fc2_pre),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), B, n, H, hd,
      M, (float)eps, mxu, attn_bf16, mlp, static_cast<cudaStream_t>(stream));
}
