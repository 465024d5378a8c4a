// The masked attention scores and softmax of a BERT layer, shared by the
// forward's attention core (bert_fwd.cu, B7) and the reverse's row pass
// (bert_attn_rev.cu, B9). The reverse recomputes the probabilities from q
// and K and divides by the forward's saved context (the AV z-rule's S1 =
// R1 / ctx), so both kernels form them by these two functions: the
// probabilities are bitwise the ones the context was made from, whatever
// tile shape each kernel gives its threads.
#pragma once

#include "rules.cuh"

namespace te {

// raw = q·kᵀ as a register micro-tile: thread (ty, tx) takes the query rows
// ty + TY·r (r < RT) of Qs and the keys tx + TX·c (c < KT) of the key tile
// Ks (both at pitch kLdk, float32 as the product takes them). Each score is
// one FMA chain over d = 0 … kMaxHeadDim − 1 in order (the zero columns
// past hd add nothing); 16-byte shared reads, (RT + KT) per 4·RT·KT FMAs.
template <int RT, int KT, int TY, int TX>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks,
                                           int ty, int tx,
                                           float (&acc)[RT][KT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxHeadDim; d += 4) {
    float q[RT][4], k[KT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) lds4(Qs + (ty + TY * r) * kLdk + d, q[r]);
#pragma unroll
    for (int c = 0; c < KT; ++c) lds4(Ks + (tx + TX * c) * kLdk + d, k[c]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int c = 0; c < KT; ++c)
#pragma unroll
        for (int r = 0; r < RT; ++r)
          acc[r][c] = fmaf(q[r][dd], k[c][dd], acc[r][c]);
  }
}

// The masked softmax of rows r < nr of a shared (rows, lds) buffer of raw
// scores src, into dst (which may be src): x_j = raw_j·scale + mask_j
// (JAX _attn_head_fwd: softmax(raw·inv_s + mask_row); non-contracting
// operations), p = softmax(x) over the keys j < n; ms holds the sample's
// mask. Warp w takes rows RW·w … RW·w + RW − 1 (then every RW·nwarps
// further), side by side; lane l takes j ≡ l (mod 32) ascending, then the
// butterfly max and sum. Columns j >= n are left as they are.
template <int RW>
__device__ __forceinline__ void masked_softmax_rows(
    const float* src, float* dst, int lds, int nr, int n, const float* ms,
    float scale, int warp, int nwarps, int lane) {
  for (int r0 = RW * warp; r0 < nr; r0 += RW * nwarps) {
    float m[RW], sum[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      m[i] = -INFINITY;
      sum[i] = 0.f;
    }
    for (int j = lane; j < n; j += kWarp) {
      const float mj = ms[j];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        if (r0 + i < nr) {
          const float x = add_rn(mul_rn(src[(r0 + i) * lds + j], scale), mj);
          dst[(r0 + i) * lds + j] = x;
          m[i] = x > m[i] ? x : m[i];
        }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) m[i] = warp_max(m[i]);
    for (int j = lane; j < n; j += kWarp)
#pragma unroll
      for (int i = 0; i < RW; ++i)
        if (r0 + i < nr) {
          float* p = dst + (r0 + i) * lds + j;
          const float e = expf(*p - m[i]);
          *p = e;
          sum[i] += e;
        }
#pragma unroll
    for (int i = 0; i < RW; ++i) sum[i] = warp_sum(sum[i]);
    for (int j = lane; j < n; j += kWarp)
#pragma unroll
      for (int i = 0; i < RW; ++i)
        if (r0 + i < nr) {
          float* p = dst + (r0 + i) * lds + j;
          *p = *p / sum[i];
        }
  }
}

}  // namespace te
