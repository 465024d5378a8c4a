// attn_fwd_core: per-head softmax(q kᵀ · scale) v, read straight from the raw
// qkv layout, written back merged.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// attn_fwd_core (_attn_fwd_kernel), which holds one sample's whole (n, 3D)
// qkv in VMEM and loops over heads.
//
// Shapes: qkv (B, n, 3D) with columns in 'n (qkv h d)' order, out (B, n, D),
// D = H·hd. One block per (tile of query rows, head, sample).
//
// What bounds it on the H100: at ViT-B shapes (n=197, hd=64) the two products
// are 2·n²·hd FMAs per (sample, head) against n·3·hd loads, so the kernel is
// bound by shared-memory bandwidth and latency of the scalar FP32 loops, not
// by device memory. The design keeps K and V of one head in shared memory
// (2·197·65·4 B ≈ 100 KB, above the 48 KB default, hence the opt-in) and
// lets each warp own one query row at a time: the scores and the full softmax
// row (all n keys) never leave shared memory, and no head transpose reaches
// device memory. K and V rows are padded to hd+1 so that lanes walking
// different keys hit different banks. Tensor cores (wgmma) and TMA are later
// work.
#include "common.cuh"

namespace te {

template <typename T>
__global__ void attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                                int n, int H, int hd, T scale,
                                int rows_per_block) {
  T* smem = reinterpret_cast<T*>(te_smem);
  const int ldk = hd + 1;
  T* Ks = smem;
  T* Vs = Ks + (size_t)n * ldk;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  T* qw = Vs + (size_t)n * ldk + (size_t)warp * (hd + n);  // q row (hd)
  T* pw = qw + hd;                                         // score row (n)

  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * hd, ld = 3 * D;
  const T* base = qkv + (size_t)b * n * ld;

  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    Ks[j * ldk + d] = base[(size_t)j * ld + D + h * hd + d];
    Vs[j * ldk + d] = base[(size_t)j * ld + 2 * D + h * hd + d];
  }
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  for (int i = row0 + warp; i < row_end; i += nwarps) {
    const T* qrow = base + (size_t)i * ld + h * hd;
    for (int d = lane; d < hd; d += kWarp) qw[d] = qrow[d];
    __syncwarp();

    T m = -INFINITY;
    for (int j = lane; j < n; j += kWarp) {
      const T* kr = Ks + j * ldk;
      T s = T(0);
      for (int d = 0; d < hd; ++d) s = fma(qw[d], kr[d], s);
      s = s * scale;
      pw[j] = s;
      m = s > m ? s : m;
    }
    m = warp_max(m);
    T sum = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T e = exp_t(pw[j] - m);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += kWarp) pw[j] = pw[j] / sum;
    __syncwarp();

    T* orow = out + ((size_t)b * n + i) * D + h * hd;
    for (int d = lane; d < hd; d += kWarp) {
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc = fma(pw[j], Vs[j * ldk + d], acc);
      orow[d] = acc;
    }
    __syncwarp();  // the next row overwrites qw and pw
  }
}

template <typename T>
int attn_fwd_launch(const T* qkv, T* out, int B, int n, int H, int hd,
                    double scale, cudaStream_t stream) {
  const int limit = max_smem_optin();
  int warps = 8;
  size_t smem = 0;
  for (; warps >= 1; warps /= 2) {
    smem = sizeof(T) * ((size_t)2 * n * (hd + 1) + (size_t)warps * (hd + n));
    if (smem <= (size_t)limit) break;
  }
  if (warps < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 4 * warps;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(attn_fwd_kernel<T>, grid, warps * kWarp, smem, stream)(
      qkv, out, n, H, hd, (T)scale, rows);
  return (int)cudaGetLastError();
}

}  // namespace te

extern "C" int te_attn_fwd_f32(const void* qkv, void* out, int B, int n,
                               int H, int hd, double scale, void* stream) {
  return te::attn_fwd_launch<float>(static_cast<const float*>(qkv),
                                    static_cast<float*>(out), B, n, H, hd,
                                    scale, static_cast<cudaStream_t>(stream));
}

extern "C" int te_attn_fwd_f64(const void* qkv, void* out, int B, int n,
                               int H, int hd, double scale, void* stream) {
  return te::attn_fwd_launch<double>(static_cast<const double*>(qkv),
                                     static_cast<double*>(out), B, n, H, hd,
                                     scale, static_cast<cudaStream_t>(stream));
}
