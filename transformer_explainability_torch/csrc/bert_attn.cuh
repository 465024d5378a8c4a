// The masked attention row of a BERT layer's forward (bert_fwd.cu, B7).
// The reverse (bert_attn_rev.cu, B9) recomputes the scores and the
// probabilities from q and K, and divides by the forward's saved context
// (the AV z-rule's S1 = R1 / ctx), so its tiled row pass forms them from the
// same operands by the same operations in this function's order (one FMA
// chain per score over d; lane l over j ≡ l (mod 32), then the butterfly):
// the probabilities are bitwise the ones the context was made from.
#pragma once

#include "gemm.cuh"

namespace te {

// One query row against the n keys of a head in shared memory (key j at
// Ks + j·ldk, float32 as stored; rounded here as the attention product of
// precision R takes it), one warp:
//   raw_j = q·k_j,   x_j = raw_j·scale + mask_j,   p = softmax(x)
// (JAX _attn_head_fwd: softmax(raw·inv_s + mask_row)). qw holds the row's
// q already rounded. Lane l writes raw (unless null) and p at
// j = l, l + 32, ...; p is the unrounded probability.
template <bool R>
__device__ __forceinline__ void masked_softmax_row(
    const float* qw, const float* Ks, int ldk, int n, int hd,
    const float* mrow, float scale, float* raw, float* p, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += kWarp) {
    const float* kr = Ks + (size_t)j * ldk;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qw[d], rnd<R>(kr[d]), s);
    if (raw) raw[j] = s;
    const float x = add_rn(mul_rn(s, scale), mrow[j]);
    p[j] = x;
    m = x > m ? x : m;
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < n; j += kWarp) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += kWarp) p[j] = p[j] / sum;
}

// Shared memory of a head's K (or V), float32, one padded row per key.
__host__ __device__ inline size_t head_kv_floats(int n, int hd) {
  return (size_t)n * (hd + 1);
}

}  // namespace te
