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
// share each weight read): the qkv GEMM, the masked attention core per
// (query tile, head, sample), the dense GEMM with the residual, LayerNorm,
// the inter GEMM with GELU, the out GEMM with the residual, LayerNorm. At
// BERT-base B=8, S=512 in production modes the attention core sets the
// pace: 0.48 of the layer's 0.85 ms on an H100 at 700 W, the GEMM core 0.36.
// The attention core's two float32 products (6.4 GFLOP, 0.10 ms at 67
// TFLOP/s) are bounded by shared memory: a 128-bit shared read is served a
// quarter-warp at a time, so a register tile that reads r floats per FMA
// runs at most at 1/(4r) of the FP32 rate. So a block takes 64 query rows
// and streams K, then V, in 64-key tiles through two shared-memory stages
// (16-byte cp.async, the next tile in flight while the block works on this
// one); the scores and P·V are 4 × 4 register tiles (0.5 floats read per
// FMA); the tile's (64, S) score rows stay in shared memory between the two
// sweeps, with the masked softmax over them in between: 13.5 TFLOP/s.
// The probabilities are bitwise the ones B9 recomputes (bert_attn_rev.cu):
// both kernels form them by bert_attn.cuh's score_tile and
// masked_softmax_rows. Each ctx output is one FMA chain over j ascending
// (the keys past n add p·0 = 0), so ctx too is bitwise that of a product
// taken one row at a time, whatever the tiles.
#include "bert_attn.cuh"

namespace te {

// The attention core: one block of 256 threads per (tile of kFwdRows = 64
// query rows, head, sample).
constexpr int kFwdRows = 64;
constexpr int kFwdThreads = 256;
constexpr int kFwdTx = 16;                // threads along the keys or d

// Shared memory in floats: the tile's (64, S) score rows (raw, then x, e, p)
// at a pitch of S padded to the key tile plus 16 (≡ 16 mod 32: a warp's two
// rows of scores land in distinct banks); two K/V stages; the q tile; the
// mask row.
struct FwdLayout {
  int Sp, lds;
  __host__ __device__ explicit FwdLayout(int n)
      : Sp((n + kKeyT - 1) / kKeyT * kKeyT), lds(Sp + 16) {}
  __host__ __device__ size_t floats() const {
    return (size_t)kFwdRows * lds + 2 * kKeyT * kLdk + kFwdRows * kLdk + Sp;
  }
};

template <bool RA>
__global__ void __launch_bounds__(kFwdThreads, 1) bert_attn_fwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ mask,
    float* __restrict__ ctx, int n, int H, int hd, float scale) {
  const FwdLayout lay(n);
  const int lds = lay.lds, Sp = lay.Sp, T = Sp / kKeyT;
  float* Ps = reinterpret_cast<float*>(te_smem);   // [kFwdRows][lds]
  float* KVs = Ps + kFwdRows * lds;                // [2][kKeyT][kLdk]
  float* Qs = KVs + 2 * kKeyT * kLdk;              // [kFwdRows][kLdk]
  float* ms = Qs + kFwdRows * kLdk;                // [Sp] mask row

  const int t = threadIdx.x, tx = t % kFwdTx, ty = t / kFwdTx;
  const int warp = t / kWarp, lane = t % kWarp;
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * kFwdRows;
  const int nr = n - row0 < kFwdRows ? n - row0 : kFwdRows;
  const int D = H * hd, ld = 3 * D;
  const float* base = qkv + (size_t)b * n * ld + h * hd;
  const bool vec = tile_vec_ok(base, ld, hd);

  // zeros where no copy writes: the columns hd … kMaxHeadDim of the stages
  // and the q tile, the q rows past n
  for (int idx = t; idx < 2 * kKeyT * kMaxHeadDim; idx += kFwdThreads) {
    const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
    if (c >= hd) KVs[r * kLdk + c] = 0.f;
  }
  for (int idx = t; idx < kFwdRows * kMaxHeadDim; idx += kFwdThreads) {
    const int r = idx / kMaxHeadDim, c = idx - r * kMaxHeadDim;
    if (r >= nr || c >= hd) Qs[r * kLdk + c] = 0.f;
  }
  for (int j = t; j < Sp; j += kFwdThreads)
    ms[j] = j < n ? mask[(size_t)b * n + j] : 0.f;
  load_tile_async(Qs, kLdk, base + (size_t)row0 * ld, ld, nr, hd, vec);
  cp_async_commit();

  // stream tile s: K for s < T, then V
  auto fetch = [&](int s) {
    const int j0 = (s % T) * kKeyT;
    stream_kv_tile(KVs + (s & 1) * kKeyT * kLdk,
                   base + (size_t)j0 * ld + (s < T ? D : 2 * D), ld,
                   n - j0 < kKeyT ? n - j0 : kKeyT, hd, vec);
  };

  // thread (ty, tx) owns rows ty + 16r (r < 4) and keys tx + 16c of a K
  // tile, then columns 4tx … 4tx + 3 of ctx
  float o[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[r][e] = 0.f;

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
    if (RA) {   // the attention products take q, K, V and p as bf16
      for (int idx = t; idx < kKeyT * kLdk; idx += kFwdThreads)
        st[idx] = round_bf16(st[idx]);
      if (s == 0)
        for (int idx = t; idx < kFwdRows * kLdk; idx += kFwdThreads)
          Qs[idx] = round_bf16(Qs[idx]);
      __syncthreads();
    }
    const int j0 = (s % T) * kKeyT;
    if (s < T) {
      // raw = q·kᵀ (bert_attn.cuh, as B9 recomputes it)
      float acc[4][4];
      score_tile<4, 4, kFwdRows / 4, kFwdTx>(Qs, st, ty, tx, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Ps[(ty + 16 * r) * lds + j0 + tx + kFwdTx * c] = acc[r][c];
    } else {
      // ctx = P·V, each output one FMA chain over j ascending (the keys past
      // n add p·0: their scores are q·0 = 0 and their V rows zero)
      const float* vt = st + 4 * tx;
      for (int jj = 0; jj < kKeyT; jj += 4) {
        float p[4][4], v[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) lds4(Ps + (ty + 16 * r) * lds + j0 + jj, p[r]);
#pragma unroll
        for (int u = 0; u < 4; ++u) lds4(vt + (jj + u) * kLdk, v[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[r][e] = fmaf(p[r][u], v[u][e], o[r][e]);
      }
    }
    __syncthreads();   // the stage is consumed
    if (s == T - 1) {
      // the masked softmax (bert_attn.cuh, as B9 recomputes it)
      masked_softmax_rows<kFwdRows / (kFwdThreads / kWarp)>(
          Ps, Ps, lds, nr, n, ms, scale, warp, kFwdThreads / kWarp, lane);
      if (RA) {
        __syncthreads();
        for (int idx = t; idx < kFwdRows * lds; idx += kFwdThreads)
          Ps[idx] = round_bf16(Ps[idx]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= nr) continue;
    float* orow = ctx + ((size_t)b * n + row0 + i) * D + h * hd;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * tx + e < hd) orow[4 * tx + e] = o[r][e];
  }
}

template <bool RA>
int bert_attn_fwd(const float* qkv, const float* mask, float* ctx, int B,
                  int n, int H, int hd, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * FwdLayout(n).floats();
  if (hd > kMaxHeadDim || smem > (size_t)max_smem_optin())
    return (int)cudaErrorInvalidValue;
  auto kern = bert_attn_fwd_kernel<RA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, H, B);
  TE_LAUNCH(kern, grid, kFwdThreads, smem, stream)(qkv, mask, ctx, n, H, hd,
                                                   scale);
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
