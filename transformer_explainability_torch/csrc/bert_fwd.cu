// bert_layer_fwd_core: one whole post-norm BERT encoder layer forward with
// the additive attention mask, and its slim rich anchors.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// bert_layer_fwd_core (_bert_fwd_kernel / _bert_fwd_math), one Pallas
// program per (sample, layer) with all weights in VMEM:
//   qkv_pre = x·Wqkvᵀ (mxu); q, k, v = qkv_pre + bqkv
//   per head: raw = q·kᵀ (attn_mxu), p = softmax(raw·scale + mask),
//             ctx = p·v (attn_mxu)
//   dense_nb = ctx·Waoᵀ (mxu); att_ln = LN1(x + (dense_nb + b_ao))
//   inter_pre = att_ln·Wiᵀ (mlp); inter_g = gelu(inter_pre + b_i)
//   dense2_nb = inter_g·Woᵀ (mlp); out = LN2(att_ln + (dense2_nb + b_o))
// and saves att_ln and the slim anchors qkv_pre, ctx, dense_nb for
// bert_attn_rev_core. Post-norm: each LayerNorm follows its residual add.
//
// What bounds it on the H100: as block_fwd.cu, one sample's weights and
// the (S, I) activations do not fit in a block's 227 KB of shared memory,
// so the layer is a sequence of launches over the whole batch (B·S rows
// share each weight read): the qkv GEMM, the masked attention core per (row
// tile, head, sample), the dense GEMM with the residual, LayerNorm, the
// inter GEMM with GELU, the out GEMM with the residual, LayerNorm. At S=512
// a head's K and V together (266 KB) do not fit in shared memory either, so
// the attention core runs in two passes over one K/V buffer: K resident,
// the tile's probabilities into shared memory; then V resident, ctx = P·V.
#include "bert_attn.cuh"

namespace te {

// One block per (row tile, head, sample), one warp per query row.
template <bool RA>
__global__ void bert_attn_fwd_kernel(const float* __restrict__ qkv,
                                     const float* __restrict__ mask,
                                     float* __restrict__ ctx, int n, int H,
                                     int hd, float scale, int rows) {
  float* smem = reinterpret_cast<float*>(te_smem);
  const int ldk = hd + 1;
  float* KV = smem;                                  // [n][hd + 1]
  float* P = KV + head_kv_floats(n, hd);             // [rows][n]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  float* qw = P + (size_t)rows * n + (size_t)warp * hd;

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv + (size_t)b * n * ld;
  const float* mrow = mask + (size_t)b * n;
  const int row0 = blockIdx.x * rows;
  const int nr = n - row0 < rows ? n - row0 : rows;

  // pass 1: K resident; each warp's rows of probabilities into P
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    KV[j * ldk + d] = base[(size_t)j * ld + D + h * hd + d];
  }
  __syncthreads();
  for (int r = warp; r < nr; r += nwarps) {
    const float* qrow = base + (size_t)(row0 + r) * ld + h * hd;
    for (int d = lane; d < hd; d += kWarp) qw[d] = rnd<RA>(qrow[d]);
    __syncwarp();
    masked_softmax_row<RA>(qw, KV, ldk, n, hd, mrow, scale, nullptr,
                           P + (size_t)r * n, lane);
    __syncwarp();  // the next row overwrites qw
  }
  __syncthreads();

  // pass 2: V resident; ctx = P·V
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    KV[j * ldk + d] = base[(size_t)j * ld + 2 * D + h * hd + d];
  }
  __syncthreads();
  for (int r = warp; r < nr; r += nwarps) {
    const float* pr = P + (size_t)r * n;
    float* orow = ctx + ((size_t)b * n + row0 + r) * D + h * hd;
    for (int d = lane; d < hd; d += kWarp) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        acc = fmaf(rnd<RA>(pr[j]), rnd<RA>(KV[j * ldk + d]), acc);
      orow[d] = acc;
    }
  }
}

template <bool RA>
int bert_attn_fwd(const float* qkv, const float* mask, float* ctx, int B,
                  int n, int H, int hd, float scale, cudaStream_t stream) {
  const int limit = max_smem_optin(), warps = 8;
  int rows = 4 * warps;
  size_t smem = 0;
  for (; rows >= 1; rows /= 2) {
    smem = sizeof(float) * (head_kv_floats(n, hd) + (size_t)rows * n +
                            (size_t)warps * hd);
    if (smem <= (size_t)limit) break;
  }
  if (rows < 1) return (int)cudaErrorInvalidValue;
  auto kern = bert_attn_fwd_kernel<RA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(kern, grid, warps * kWarp, smem, stream)(qkv, mask, ctx, n, H,
                                                     hd, scale, rows);
  return (int)cudaGetLastError();
}

int bert_fwd(const float* x, const float* mask, const BlockWeights& w,
             float* out, float* att_ln, float* qkv_pre, float* ctx,
             float* dense_nb, char* work, size_t* work_bytes, int B, int n,
             int H, int hd, int I, float eps, int mxu, int attn_bf16, int mlp,
             cudaStream_t stream) {
  const int D = H * hd, rows = B * n;
  const size_t rD = (size_t)rows * D, rI = (size_t)rows * I;
  Carve ws{work};
  float* qkv = ws.take<float>(3 * rD);
  float* sum = ws.take<float>(rD);       // x + dense, then att_ln + dense2
  float* inter_pre = ws.take<float>(rI);
  float* inter_g = ws.take<float>(rI);
  float* dense2_nb = ws.take<float>(rD);
  if (work == nullptr) {
    *work_bytes = ws.used;
    return 0;
  }
  const float scale = (float)pow((double)hd, -0.5);   // as hd ** -0.5

  TE_TRY(gemm<true, false, false>(
      mxu, GemmArgs{x, w.wqkv_hi, w.wqkv_lo, D, D, rows, 3 * D, D},
      EpiQkv{qkv_pre, qkv, w.bqkv, 3 * D}, stream));
  TE_TRY(attn_bf16 ? bert_attn_fwd<true>(qkv, mask, ctx, B, n, H, hd, scale,
                                         stream)
                   : bert_attn_fwd<false>(qkv, mask, ctx, B, n, H, hd, scale,
                                          stream));
  TE_TRY(gemm<true, false, false>(
      mxu, GemmArgs{ctx, w.wproj_hi, w.wproj_lo, D, D, rows, D, D},
      EpiResidual{dense_nb, sum, x, w.bproj, D}, stream));
  TE_TRY(ln_fwd(sum, w.ln1s, w.ln1b, att_ln, rows, D, eps, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{att_ln, w.w1_hi, w.w1_lo, D, D, rows, I, D},
      EpiGelu{inter_pre, inter_g, w.b1, I}, stream));
  TE_TRY(gemm<true, false, false>(
      mlp, GemmArgs{inter_g, w.w2_hi, w.w2_lo, I, I, rows, D, I},
      EpiResidual{dense2_nb, sum, att_ln, w.b2, D}, stream));
  TE_TRY(ln_fwd(sum, w.ln2s, w.ln2b, out, rows, D, eps, stream));
  return 0;
}

}  // namespace te

// Plain C entry point (float32). Pointers: x, mask (B, n) additive; the
// layer's vectors attn_ln scale, bias, out_ln scale, bias, b_qkv, b_ao, b_i,
// b_o; the weight planes (hi, lo) of qkv, attention output, inter, out (lo
// may be null for one-pass modes); the outputs out, att_ln, qkv_pre, ctx,
// dense_nb; the workspace. With a null workspace it only writes the
// workspace size to *work_bytes. Modes: mxu and mlp 0 = bf16, 1 = bf16×3;
// attn_bf16 1 = bf16 operands, 0 = float32.
extern "C" int te_bert_fwd_f32(
    const void* x, const void* mask, const void* ln1s, const void* ln1b,
    const void* ln2s, const void* ln2b, const void* bqkv, const void* bao,
    const void* bi, const void* bo, const void* wqkv_hi, const void* wqkv_lo,
    const void* wao_hi, const void* wao_lo, const void* wi_hi,
    const void* wi_lo, const void* wo_hi, const void* wo_lo, void* out,
    void* att_ln, void* qkv_pre, void* ctx, void* dense_nb, void* work,
    void* work_bytes, int B, int n, int H, int hd, int I, double eps, int mxu,
    int attn_bf16, int mlp, void* stream) {
  using F = const float*;
  using W = const uint16_t*;
  te::BlockWeights w{
      static_cast<F>(ln1s), static_cast<F>(ln1b), static_cast<F>(ln2s),
      static_cast<F>(ln2b), static_cast<F>(bqkv), static_cast<F>(bao),
      static_cast<F>(bi), static_cast<F>(bo), static_cast<W>(wqkv_hi),
      static_cast<W>(wqkv_lo), static_cast<W>(wao_hi), static_cast<W>(wao_lo),
      static_cast<W>(wi_hi), static_cast<W>(wi_lo), static_cast<W>(wo_hi),
      static_cast<W>(wo_lo)};
  return te::bert_fwd(
      static_cast<F>(x), static_cast<F>(mask), w, static_cast<float*>(out),
      static_cast<float*>(att_ln), static_cast<float*>(qkv_pre),
      static_cast<float*>(ctx), static_cast<float*>(dense_nb),
      static_cast<char*>(work), static_cast<size_t*>(work_bytes), B, n, H, hd,
      I, (float)eps, mxu, attn_bf16, mlp, static_cast<cudaStream_t>(stream));
}
