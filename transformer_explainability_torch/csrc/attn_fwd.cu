// attn_fwd_core: per-head softmax(q kᵀ · scale) v, read straight from the raw
// qkv layout, written back merged.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// attn_fwd_core (_attn_fwd_kernel), which holds one sample's whole (n, 3D)
// qkv in VMEM and loops over heads.
//
// Shapes: qkv (B, n, 3D) with columns in 'n (qkv h d)' order, out (B, n, D),
// D = H·hd, any H, hd <= 64, n up to what shared memory holds (float:
// about 550). One block of 4·QT threads per (tile of QT <= 64 query rows,
// head, sample): 64 rows at ViT-B (4 × H × B blocks).
//
// What bounds it on the H100: operations. At ViT-B, B=8 (n=197, hd=64) the
// two products are 2 · 8·12·197²·64 FMAs = 0.95 GFLOP, 0.0142 ms at the
// 67 TFLOP/s of FP32 off the tensor cores, against 19.4 MB of qkv and out
// (0.0058 ms at 3.35 TB/s). The exact-FP32 mode must stay off the tensor
// cores, so the design is a register-tiled SIMT kernel. A warp's 128-bit
// shared reads are served a quarter-warp at a time, so what limits such a
// kernel is the floats each thread reads per FMA, and the tiles are sized
// for that:
// - the scores are 8 × 8 register tiles (warp w: rows 8w … 8w+7; lane l:
//   keys l + 32c), 16 floats per 64 FMAs; where the row fits in one tile
//   (n <= 256) the softmax runs on them in registers, a warp's 8 rows side
//   by side, so no latency-bound pass over shared memory is left;
// - P·V is 8 × 8 register tiles too in float32 mode, four groups of the
//   threads each taking one range of keys, the groups' sums meeting in
//   shared memory and joining in a fixed order; in the bf16 modes 4 × 4
//   tiles on every thread, each output one chain over the keys;
// - Q and K (then V) are copied with 16-byte cp.async; P and V then take
//   the place of Q and K, so two blocks fit an SM (105 KB at ViT-B); warps
//   whose rows lie past n (the last tile at n = 197 holds 5) skip the
//   products.
// Every sum runs in a fixed order, so the kernel is bitwise repeatable.
// The probabilities are formed in a softmax row pass's order (max, exp,
// lane l summing keys l + 32c, the butterfly, then e / Σ). In float32 mode
// P·V sums its key ranges apart; in the bf16 modes each output is one chain
// over j = 0 … n−1 in order. The tile's code lives in attn_fwd.cuh: B2's
// attention core (block_fwd.cu) is an instance of this kernel that also
// stores the pre-scale scores and the probabilities, and B5's row pass
// (attn_rev.cu) recomputes the probabilities by the same function, so they
// are bitwise B4's.
//
// Modes (the JAX kernel's mxu): float32 products (exact FP32), bf16 (q, k,
// v and the probability row rounded to bf16 as the products take them,
// rounded in shared memory once, float32 sums) or bf16×3 (each product
// three passes lo·hi, hi·lo, hi·hi over the unrounded operands, split as
// they are loaded, into one float32 chain; attn_fwd.cuh) — the same SIMT
// loops, so no tensor-core accumulation order enters.
#include "attn_fwd.cuh"

// Plain C entry points. attn_mode: 0 = float32, 1 = bf16, 2 = bf16×3.
#define TE_ATTN_FWD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* qkv, void* out, int B, int n, int H,       \
                      int hd, double scale, int attn_mode, void* stream) {   \
    if (attn_mode < te::kModeF32 || attn_mode > te::kModeBf16x3)                     \
      return (int)cudaErrorInvalidValue;                                     \
    const auto launch = attn_mode == te::kModeBf16x3                             \
                            ? te::attn_fwd_launch<T, te::kModeBf16x3>            \
                        : attn_mode ? te::attn_fwd_launch<T, te::kModeBf16>      \
                                    : te::attn_fwd_launch<T, te::kModeF32>;      \
    return launch(static_cast<const T*>(qkv), static_cast<T*>(out), nullptr, \
                  nullptr, B, n, H, hd, scale,                               \
                  static_cast<cudaStream_t>(stream));                        \
  }

TE_ATTN_FWD_ENTRY(te_attn_fwd_f32, float)
TE_ATTN_FWD_ENTRY(te_attn_fwd_f64, double)
