// rollout_from_grad_cam: the rollout chain joint = Π_{l=L-1..start} (I + m_l)
// over pre-reduced (B, L, n, n) maps, optionally row-normalised, or over
// per-head (B, L, h, n, n) maps (with optional grads) head-meaned first. It
// returns the product's leading `rows` rows: all n (the full form, what the
// JAX kernel returns) or row 0 alone (the row form, all any caller reads).
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// rollout_from_grad_cam (_chain_kernel), a single TPU program that keeps the
// (L, N, N) stack and the running product in VMEM.
//
// One launch. Taken left to right, J ← mats[L-1], then J ← J · mats[l] for
// l = L-2 down to start (mats[l] = m_l + I, each row divided by its sum when
// row-normalised). A block of rows of J then evolves from that same block
// and the whole of mats[l], which is an input. So one thread block per (row
// block, sample) carries its R rows of J in shared memory through every
// layer: no grid-wide sync, no cluster, no running product in device
// memory. The block streams mats[l] as tiles of kt whole rows through a
// ring that runs on across layer boundaries: a tile is one contiguous span,
// so one thread moves it by one TMA bulk copy of its 16-byte-aligned body
// (completing on the slot's mbarrier) and 4-byte cp.async for the few bytes
// before and after, whatever n is. The +I and the normalisation come from
// the tile the block holds: eight threads form a tile row's sum s_k and the
// J column it multiplies, J[:, k] / s_k, before the tile's FMAs, and the
// identity's term J[:, j] / s_j joins each output at the layer's end. The
// products are exact FP32 FMAs (the port's parity mode; JAX pins
// Precision.HIGHEST), no tensor cores, in registers. Every sum runs in a
// fixed order, with no atomics, so the results are bitwise repeatable
// (float32 results move from the right-to-left order of the plain version
// at the ulp level; every operand is non-negative, so nothing cancels).
//
// What bounds each form on the H100, and what the design does about it:
// - the row form (R = 1, one block per sample) does L·n² FMAs a sample and
//   is bounded by the bytes it must move: row 0 of mats[L-1] and the whole
//   of mats[L-2..start] read, row 0 written, (L - 1 - start)·B·n² + 2·B·n
//   floats: 13.7 MB, 0.0041 ms at 3.35 TB/s at ViT-B/16 B=8. Its B blocks
//   each have an SM to themselves, so everything serves one SM's intake: a
//   ring of 3 stages of up to 128 rows (~200 KB, one TMA copy a tile:
//   per-tile costs dominate smaller tiles), and the eight warps split each
//   tile's rows (warp w takes rows kk ≡ w mod 8, its J value a broadcast),
//   so every tile element is read from shared memory once; their partial
//   rows join at the layer's end. One SM's intake still holds it well above
//   its bound: splitting a sample's columns over a thread-block cluster,
//   the row swapped through distributed shared memory once a layer, would
//   put more SMs on those bytes (later work).
// - the full form (R = 12: ⌈197/12⌉·8 = 136 blocks at ViT-B/16 B=8, 344 at
//   n = 512, enough to cover the 132 SMs) is bounded by its operations,
//   2·B·(L-1-start)·n³: 0.0201 ms at 67 TFLOP/s FP32 at ViT-B/16 B=8. Four
//   row groups of 3 rows over 64 column threads: 3 × 4 (n ≤ 256) to 3 × 16
//   register tiles, reading 7/12 to 19/48 floats from shared memory a FMA,
//   which bounds it; its smaller ring (80 KB) leaves room for two blocks an
//   SM, and its float32 launch bounds hold it to 128 registers for that.
// - above 1024 tokens the register tiles cannot span a row: the wide
//   instances walk the columns in passes of 512, each pass's accumulators
//   kept in shared memory (P) between tiles. n is then bounded by one
//   block's shared memory (the launch refuses what does not fit: about
//   4,400 tokens for the row form in float32, 2,000 for the full form).
// - the per-head pass reads the (B, L, h, n, n) maps once, over every SM,
//   and writes mean_h (grads ⊙ cams)⁺ for layers start..L-1, which the
//   chain then reads: bytes-bound. Fusing it into the row form's loads
//   would make B blocks read h× (2h× with grads) the bytes from B SMs.
//
// experiments/torch_b1_variants.py builds variants of the chain with these
// switches: TE_B1_NO_FMAS (the products skipped), TE_B1_NO_COPIES (the
// tiles' TMA copies skipped, their barriers expecting no bytes),
// TE_B1_ROW_STAGES (the row form's ring depth) and TE_B1_COPY_BYTES (a
// tile's body moved in TMA copies of at most these bytes; 0: one copy).
#include "common.cuh"

#ifndef TE_B1_ROW_STAGES
#define TE_B1_ROW_STAGES 3
#endif
#ifndef TE_B1_COPY_BYTES
#define TE_B1_COPY_BYTES 0
#endif

namespace te {

constexpr int kChainThreads = 256;
constexpr int kChainWarps = kChainThreads / kWarp;
constexpr int kMaxTileRows = 128;  // k rows a ring stage holds at most
constexpr int kSumGroup = 8;       // threads forming one tile row's sum
// the two forms: rows R, row groups TR, warps splitting k KS, ring stages
// and ring bytes; a request for fewer rows than the full form's R takes the
// row form
constexpr int kRowR = 1, kRowTR = 1, kRowKS = kChainWarps,
              kRowStages = TE_B1_ROW_STAGES;
constexpr size_t kRowRing = 200 * 1024;
constexpr int kFullR = 12, kFullTR = 4, kFullKS = 1, kFullStages = 3;
constexpr size_t kFullRing = 80 * 1024;

// Shared memory of one chain block, in bytes, every piece 16-byte aligned:
// the ring's full barriers; J (R × n); the KS partial products of a layer
// (KS × R × n); the tile's J columns over their row sums (R × kt) and the
// layer's row sums (n), used when row-normalising; the ring (STAGES slots of
// kt·n elements, each with room for its source's 16-byte phase).
struct ChainLayout {
  size_t j, p, as, s, ring, slot, total;
  __host__ __device__ static size_t up(size_t x) { return (x + 15) / 16 * 16; }
  __host__ __device__ ChainLayout(size_t esize, int R, int KS, int n, int kt,
                                  int stages) {
    j = up(sizeof(uint64_t) * stages);
    p = j + up(esize * R * n);
    as = p + up(esize * KS * R * n);
    s = as + up(esize * R * kt);
    ring = s + up(esize * n);
    slot = up(esize * kt * n + 16);
    total = ring + (size_t)stages * slot;
  }
};

// v summed over aligned groups of kSumGroup lanes, every lane of a group
// ending with the same value (a butterfly, as warp_sum)
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
  for (int o = 1; o < kSumGroup; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The ring that streams mats[L-2], mats[L-3], ... as tiles of kt whole rows
// (per_layer tiles a layer, the last one ragged); tile t lands in slot
// t % STAGES at its source's 16-byte phase.
template <typename T, int STAGES>
struct ChainRing {
  const T* top;   // mats[L-2] of this sample
  int n, kt, per_layer, tiles;
  char* slots;
  size_t slot;
  uint64_t* full;

  __device__ __forceinline__ const char* source(int t) const {
    return reinterpret_cast<const char*>(
        top - (size_t)(t / per_layer) * n * n +
        (size_t)(t % per_layer) * kt * n);
  }
  __device__ __forceinline__ char* staged(int t) const {
    return slots + (size_t)(t % STAGES) * slot +
           ((uintptr_t)source(t) & 15);
  }
  // by one thread: tile t's 16-byte-aligned body by TMA, completing on the
  // slot's barrier, the few bytes before and after it by 4-byte cp.async
  // in one commit group (empty past the last tile)
  __device__ __forceinline__ void issue(int t) const {
    if (t < tiles) {
      const int k0 = (t % per_layer) * kt;
      const int kr = kt < n - k0 ? kt : n - k0;
      const char* src = source(t);
      char* dst = staged(t);
      const uint32_t bytes = (uint32_t)(sizeof(T) * kr * n);
      uint32_t head = (16 - ((uintptr_t)src & 15)) & 15;
      if (head > bytes) head = bytes;
      const uint32_t body = (bytes - head) & ~15u;
      uint64_t* bar = full + t % STAGES;
      for (uint32_t o = 0; o < head; o += 4) cp_async4(dst + o, src + o);
      for (uint32_t o = head + body; o < bytes; o += 4)
        cp_async4(dst + o, src + o);
#ifdef TE_B1_NO_COPIES
      mbar_arrive_expect_tx(bar, 0);
#else
      mbar_arrive_expect_tx(bar, body);
      const uint32_t chunk = TE_B1_COPY_BYTES ? TE_B1_COPY_BYTES : body;
      for (uint32_t o = 0; o < body; o += chunk)
        bulk_load(dst + head + o, src + head + o,
                  body - o < chunk ? body - o : chunk, bar);
#endif
    }
    cp_async_commit();
  }
};

// One (row block, sample) of the chain: out[b, r0 + i, :] for the block's
// rows r0 + i < rows. Threads: TR row groups × KS k groups × TC = 256 /
// (TR·KS) column threads; thread (tr, ks, tc) carries rows tr·RT + i
// (i < RT) and columns tc + c·TC (c < CT) of the layer's product over the
// tile rows kk ≡ ks (mod KS) in registers; WIDE instances take the columns
// in passes of CT·TC, each pass's accumulators kept in P between tiles. The row form splits k over its warps (KS = 8, a warp's A value a
// broadcast, every tile element read once); the full form splits rows (TR =
// 4, KS = 1). At a layer's end the KS partial products and the identity's
// term join in a fixed order.
template <typename T, int R, int TR, int KS, int CT, int STAGES, bool WIDE>
__global__ void __launch_bounds__(kChainThreads,
                                  R > 1 && sizeof(T) == 4 ? 2 : 1)
    rollout_chain_kernel(const T* __restrict__ cams, T* __restrict__ out,
                         int L, int n, int start, int rows, int kt,
                         int row_normalize) {
  constexpr int TC = kChainThreads / (TR * KS), RT = R / TR;
  static_assert(RT * TR == R && TC % kWarp == 0, "thread layout");
  const ChainLayout lay(sizeof(T), R, KS, n, kt, STAGES);
  uint64_t* full = reinterpret_cast<uint64_t*>(te_smem);
  T* J = reinterpret_cast<T*>(te_smem + lay.j);
  T* P = reinterpret_cast<T*>(te_smem + lay.p);
  T* As = reinterpret_cast<T*>(te_smem + lay.as);
  T* S = reinterpret_cast<T*>(te_smem + lay.s);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int tc = tid % TC, ks = (tid / TC) % KS, tr = tid / (TC * KS);
  const int b = blockIdx.y, r0 = blockIdx.x * R;
  const size_t nn = (size_t)n * n;
  const T* mb = cams + (size_t)b * L * nn;
  const int per_layer = (n + kt - 1) / kt;
  const ChainRing<T, STAGES> ring{
      mb + ((ptrdiff_t)L - 2) * (ptrdiff_t)nn, n, kt, per_layer,
      (L - 1 - start) * per_layer,
      reinterpret_cast<char*>(te_smem + lay.ring), lay.slot, full};
  const int tiles = ring.tiles;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < STAGES - 1; ++t) ring.issue(t);

  // J ← rows r0.. of mats[L-1] (rows past n: 0), a warp a row
  for (int i = warp; i < R; i += kChainWarps) {
    const int r = r0 + i;
    T* Jr = J + (size_t)i * n;
    if (r >= n) {
      for (int j = lane; j < n; j += kWarp) Jr[j] = T(0);
      continue;
    }
    const T* mr = mb + (size_t)(L - 1) * nn + (size_t)r * n;
    T sum = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T v = mr[j] + (j == r ? T(1) : T(0));
      Jr[j] = v;
      sum += v;
    }
    if (row_normalize) {
      sum = warp_sum(sum);
      for (int j = lane; j < n; j += kWarp) Jr[j] = Jr[j] / sum;
    }
  }

  // this thread's partial products in P: P[ks][tr·RT + i][j]
  T* Pt = P + ((size_t)ks * R + tr * RT) * n;
  const int passes = WIDE ? (n + CT * TC - 1) / (CT * TC) : 1;
#ifdef TE_B1_NO_FMAS
  constexpr bool kFmas = false;
#else
  constexpr bool kFmas = true;
#endif
  T acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = T(0);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    mbar_wait(full + t % STAGES, (uint32_t)(t / STAGES) & 1u);
    __syncthreads();   // tile t landed; every thread is done with tile t-1
    if (tid == 0) ring.issue(t + STAGES - 1);
    const int k0 = (t % per_layer) * kt;
    const int kr = kt < n - k0 ? kt : n - k0;
    const bool first = t % per_layer == 0;
    const bool last = t % per_layer == per_layer - 1;
    const T* tile = reinterpret_cast<const T*>(ring.staged(t));
    const T* A = J + k0;   // A[row·astride + kk] multiplies tile row kk
    int astride = n;
    if (row_normalize) {
      // s_k = Σ_j (m + I)[k, j] of the tile's rows, kSumGroup threads a
      // row, and J[:, k] / s_k
      const int g = tid % kSumGroup;
      for (int kk0 = 0; kk0 < kr; kk0 += kChainThreads / kSumGroup) {
        const int kk = kk0 + tid / kSumGroup, k = k0 + kk;
        T sum = T(0);
        if (kk < kr) {
          const T* row = tile + (size_t)kk * n;
#pragma unroll 4
          for (int j = g; j < n; j += kSumGroup)
            sum += row[j] + (j == k ? T(1) : T(0));
        }
        sum = group_sum(sum);
        if (kk < kr) {
          if (g == 0) S[k] = sum;
          for (int i = g; i < R; i += kSumGroup)
            As[(size_t)i * kt + kk] = J[(size_t)i * n + k] / sum;
        }
      }
      __syncthreads();
      A = As;
      astride = kt;
    }
    for (int pass = 0; pass < passes; ++pass) {
      const int j0 = pass * CT * TC + tc;   // this thread's first column
      if (WIDE && !first) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = j0 + c * TC;
#pragma unroll
          for (int i = 0; i < RT; ++i)
            acc[i][c] = j < n ? Pt[(size_t)i * n + j] : T(0);
        }
      }
#pragma unroll 2
      for (int kk = ks; kk < (kFmas ? kr : 0); kk += KS) {
        T a[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          a[i] = A[(size_t)(tr * RT + i) * astride + kk];
        const T* trow = tile + (size_t)kk * n;
        T bv[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = j0 + c * TC;   // columns past n read column n - 1
          bv[c] = trow[j < n ? j : n - 1];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[i][c] = fma(a[i], bv[c], acc[i][c]);
      }
      if (WIDE || last) {
        // the pass's partial product into P (at the layer's last tile: the
        // layer's), the accumulators cleared for the next
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int j = j0 + c * TC;
            if (j < n) Pt[(size_t)i * n + j] = acc[i][c];
            acc[i][c] = T(0);
          }
      }
    }
    if (last) {
      // J ← Σ_ks P[ks] + J / s (the identity's term), in that order
      __syncthreads();
      for (int e = tid; e < R * n; e += kChainThreads) {
        T v = P[e];
#pragma unroll
        for (int q = 1; q < KS; ++q) v += P[(size_t)q * R * n + e];
        const T id = J[e];
        J[e] = v + (row_normalize ? id / S[e % n] : id);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = warp; i < R && r0 + i < rows; i += kChainWarps) {
    T* o = out + ((size_t)b * rows + r0 + i) * n;
    for (int j = lane; j < n; j += kWarp) o[j] = J[(size_t)i * n + j];
  }
}

// out[b, l - start] = mean_h (grads ⊙ cams)⁺[b, l] (cams⁺ without grads)
// for l = start..L-1, one output element a thread, heads summed in order.
template <typename T>
__global__ void rollout_head_mean_kernel(const T* __restrict__ cams,
                                         const T* __restrict__ grads,
                                         T* __restrict__ out, int L, int h,
                                         int n, int start, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t nn = (size_t)n * n, layers = (size_t)(L - start);
  const size_t e = idx % nn, bl = idx / nn;
  const size_t b = bl / layers, l = start + bl % layers;
  const size_t base = (b * L + l) * h * nn + e;
  T s = T(0);
#pragma unroll 4
  for (int i = 0; i < h; ++i) {
    T v = cams[base + (size_t)i * nn];
    if (grads) v = grads[base + (size_t)i * nn] * v;
    s += v < T(0) ? T(0) : v;   // clamp(min=0): NaN stays NaN
  }
  out[idx] = s / T(h);
}

// the instance for n: the narrowest register tile CT1 ≤ CT2 ≤ CT3 whose
// columns span a row, else CT2's in column passes
template <typename T, int R, int TR, int KS, int STAGES, int CT1, int CT2,
          int CT3>
int chain_launch(const T* cams, T* out, int B, int L, int n, int start,
                 int rows, int row_normalize, size_t ring_bytes,
                 cudaStream_t stream) {
  constexpr int TC = kChainThreads / (TR * KS);
  auto kern =
      n <= CT1 * TC   ? rollout_chain_kernel<T, R, TR, KS, CT1, STAGES, false>
      : n <= CT2 * TC ? rollout_chain_kernel<T, R, TR, KS, CT2, STAGES, false>
      : n <= CT3 * TC ? rollout_chain_kernel<T, R, TR, KS, CT3, STAGES, false>
                      : rollout_chain_kernel<T, R, TR, KS, CT2, STAGES, true>;
  // the deepest tiles the ring's bytes and the block's shared memory allow
  const size_t limit = (size_t)max_smem_optin();
  int kt = (int)(ring_bytes / (sizeof(T) * STAGES * (size_t)n));
  if (kt > kMaxTileRows) kt = kMaxTileRows;
  if (kt > n) kt = n;
  while (kt > 1 &&
         ChainLayout(sizeof(T), R, KS, n, kt, STAGES).total > limit)
    --kt;
  if (kt < 1) kt = 1;
  const size_t smem = ChainLayout(sizeof(T), R, KS, n, kt, STAGES).total;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((rows + R - 1) / R, B);
  TE_LAUNCH(kern, grid, kChainThreads, smem, stream)(
      cams, out, L, n, start, rows, kt, row_normalize);
  return (int)cudaGetLastError();
}

template <typename T>
int rollout_launch(const T* cams, const T* grads, T* out, T* work, int B,
                   int L, int h, int n, int start, int row_normalize,
                   int rows, cudaStream_t stream) {
  if (B < 1 || n < 1 || h < 0 || start < 0 || start >= L || rows < 1 ||
      rows > n || (h > 0 && work == nullptr) || (h == 0 && grads))
    return (int)cudaErrorInvalidValue;
  if (h > 0) {
    const size_t total = (size_t)B * (L - start) * n * n;
    const int threads = 256;
    TE_LAUNCH(rollout_head_mean_kernel<T>,
              (unsigned)((total + threads - 1) / threads), threads, 0,
              stream)(cams, grads, work, L, h, n, start, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cams = work;
    L -= start;
    start = 0;
  }
  if (rows < kFullR)
    return chain_launch<T, kRowR, kRowTR, kRowKS, kRowStages, 7, 16, 32>(
        cams, out, B, L, n, start, rows, row_normalize, kRowRing, stream);
  return chain_launch<T, kFullR, kFullTR, kFullKS, kFullStages, 4, 8, 16>(
      cams, out, B, L, n, start, rows, row_normalize, kFullRing, stream);
}

}  // namespace te

// Plain C entry points. cams is (B, L, n, n) when h = 0, else (B, L, h, n,
// n) with grads of its shape or null, and work (B, L - start, n, n) takes
// the head mean; out is (B, rows, n), the product's leading rows.
#define TE_ROLLOUT_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* cams, const void* grads, void* out,       \
                      void* work, int B, int L, int h, int n, int start,    \
                      int row_normalize, int rows, void* stream) {          \
    return te::rollout_launch<T>(                                            \
        static_cast<const T*>(cams), static_cast<const T*>(grads),           \
        static_cast<T*>(out), static_cast<T*>(work), B, L, h, n, start,     \
        row_normalize, rows, static_cast<cudaStream_t>(stream));             \
  }
TE_ROLLOUT_ENTRY(te_rollout_f32, float)
TE_ROLLOUT_ENTRY(te_rollout_f64, double)

extern "C" const char* te_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
