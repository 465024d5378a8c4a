// rollout_from_grad_cam: the rollout chain joint = Π_{l=L-1..start} (I + m_l)
// over pre-reduced (B, L, n, n) maps, optionally row-normalised.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// rollout_from_grad_cam (_chain_kernel), a single TPU program that keeps the
// (L, N, N) stack and the running product in VMEM.
//
// What bounds it on the H100: the chain is sequential over layers and each
// step is one (n × n) · (n × n) product per sample (2·197³ ≈ 15 MFLOP at
// ViT-B), far too little work for one block to fill the card. So the chain
// runs as one launch per layer step, each over (output tile, sample), with
// the running product ping-ponging between two buffers in device memory
// (150 KB per sample; it stays in L2). The +I (and the optional row
// normalisation) is fused into the operand load, so the (L, n, n) stack is
// never rewritten. Each step is a 32×32-tiled product in shared memory with
// FP32 FMAs; launch latency dominates at these sizes. Only row 0 of the
// product is used by the ViT path, which a vector–matrix chain could serve
// in L·n² work: later work.
#include "common.cuh"

namespace te {

constexpr int kTile = 32;
constexpr int kStepThreads = 16;   // 16 × 16 threads, 2 × 2 outputs each

// rs[b, l, i] = Σ_j (m[b, l, i, j] + δ_ij); one warp per row, fixed order.
template <typename T>
__global__ void rollout_rowsum_kernel(const T* __restrict__ cams,
                                      T* __restrict__ rs, int L, int n,
                                      int start) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int i = blockIdx.x * (blockDim.x / kWarp) + warp;
  const int l = start + blockIdx.y, b = blockIdx.z;
  if (i >= n) return;  // uniform over the warp
  const T* row = cams + (((size_t)b * L + l) * n + i) * n;
  T s = T(0);
  for (int j = lane; j < n; j += kWarp) s += row[j] + (j == i ? T(1) : T(0));
  s = warp_sum(s);
  if (lane == 0) rs[((size_t)b * L + l) * n + i] = s;
}

// (m[b, l] + I)[i, j] (/ rs[b, l, i] when rs is given)
template <typename T>
__device__ __forceinline__ T chain_operand(const T* m, const T* rs, int i,
                                           int j, int n) {
  T v = m[(size_t)i * n + j] + (i == j ? T(1) : T(0));
  return rs ? v / rs[i] : v;
}

// C[b] = (m[b, la] + I) · Bop, with Bop = (m[b, lb] + I) when lb >= 0 (the
// chain's first step) and Bop = J[b] otherwise.
template <typename T>
__global__ void rollout_step_kernel(const T* __restrict__ cams,
                                    const T* __restrict__ rs,
                                    const T* __restrict__ J,
                                    T* __restrict__ C, int L, int n, int la,
                                    int lb) {
  T* As = reinterpret_cast<T*>(te_smem);     // [kTile][kTile + 1]
  T* Bs = As + kTile * (kTile + 1);          // [kTile][kTile + 1]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kStepThreads + tx;
  const int b = blockIdx.z, i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const size_t nn = (size_t)n * n;
  const T* A = cams + ((size_t)b * L + la) * nn;
  const T* rsA = rs ? rs + ((size_t)b * L + la) * n : nullptr;
  const T* Bm = lb >= 0 ? cams + ((size_t)b * L + lb) * nn : J + (size_t)b * nn;
  const T* rsB = (lb >= 0 && rs) ? rs + ((size_t)b * L + lb) * n : nullptr;

  T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kStepThreads * kStepThreads) {
      const int r = idx / kTile, c = idx % kTile;
      const int ai = i0 + r, ak = k0 + c;
      As[r * (kTile + 1) + c] =
          (ai < n && ak < n) ? chain_operand(A, rsA, ai, ak, n) : T(0);
      const int bk = k0 + r, bj = j0 + c;
      T bv = T(0);
      if (bk < n && bj < n)
        bv = lb >= 0 ? chain_operand(Bm, rsB, bk, bj, n)
                     : Bm[(size_t)bk * n + bj];
      Bs[r * (kTile + 1) + c] = bv;
    }
    __syncthreads();
    for (int k = 0; k < kTile; ++k) {
      const T a0 = As[ty * (kTile + 1) + k];
      const T a1 = As[(ty + 16) * (kTile + 1) + k];
      const T b0 = Bs[k * (kTile + 1) + tx];
      const T b1 = Bs[k * (kTile + 1) + tx + 16];
      acc[0][0] = fma(a0, b0, acc[0][0]);
      acc[0][1] = fma(a0, b1, acc[0][1]);
      acc[1][0] = fma(a1, b0, acc[1][0]);
      acc[1][1] = fma(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  T* Cb = C + (size_t)b * nn;
  for (int r = 0; r < 2; ++r) {
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
      if (i < n && j < n) Cb[(size_t)i * n + j] = acc[r][c];
    }
  }
}

// out[b] = (m[b, l] + I) (/ rs) — the whole chain when only one layer is left.
template <typename T>
__global__ void rollout_single_kernel(const T* __restrict__ cams,
                                      const T* __restrict__ rs,
                                      T* __restrict__ out, int B, int L, int n,
                                      int l) {
  const size_t nn = (size_t)n * n;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * nn) return;
  const size_t b = idx / nn, r = idx - b * nn;
  const int i = (int)(r / n), j = (int)(r - (size_t)i * n);
  const T* rsl = rs ? rs + ((size_t)b * L + l) * n : nullptr;
  out[idx] = chain_operand(cams + ((size_t)b * L + l) * nn, rsl, i, j, n);
}

template <typename T>
int rollout_launch(const T* cams, T* out, T* buf, T* rs, int B, int L, int n,
                   int start, int row_normalize, cudaStream_t stream) {
  if (start < 0 || start >= L) return (int)cudaErrorInvalidValue;
  const int layers = L - start;
  cudaError_t err;
  const T* rsp = nullptr;
  if (row_normalize) {
    const int warps = 8;
    dim3 grid((n + warps - 1) / warps, layers, B);
    TE_LAUNCH(rollout_rowsum_kernel<T>, grid, warps * kWarp, 0, stream)(
        cams, rs, L, n, start);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rsp = rs;
  }
  if (layers == 1) {
    const size_t total = (size_t)B * n * n;
    const int threads = 256;
    TE_LAUNCH(rollout_single_kernel<T>,
              (unsigned)((total + threads - 1) / threads), threads, 0,
              stream)(cams, rsp, out, B, L, n, start);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(T) * 2 * kTile * (kTile + 1);
  dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile, B);
  dim3 block(kStepThreads, kStepThreads);
  const T* prev = nullptr;
  for (int s = 1; s < layers; ++s) {
    // the last step writes `out`; earlier steps alternate so that no step
    // reads the buffer it writes
    T* dst = ((layers - 1 - s) % 2 == 0) ? out : buf;
    TE_LAUNCH(rollout_step_kernel<T>, grid, block, smem, stream)(
        cams, rsp, prev, dst, L, n, start + s, s == 1 ? start : -1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    prev = dst;
  }
  return (int)cudaSuccess;
}

}  // namespace te

extern "C" int te_rollout_f32(const void* cams, void* out, void* buf, void* rs,
                              int B, int L, int n, int start,
                              int row_normalize, void* stream) {
  return te::rollout_launch<float>(
      static_cast<const float*>(cams), static_cast<float*>(out),
      static_cast<float*>(buf), static_cast<float*>(rs), B, L, n, start,
      row_normalize, static_cast<cudaStream_t>(stream));
}

extern "C" int te_rollout_f64(const void* cams, void* out, void* buf, void* rs,
                              int B, int L, int n, int start,
                              int row_normalize, void* stream) {
  return te::rollout_launch<double>(
      static_cast<const double*>(cams), static_cast<double*>(out),
      static_cast<double*>(buf), static_cast<double*>(rs), B, L, n, start,
      row_normalize, static_cast<cudaStream_t>(stream));
}

extern "C" const char* te_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
