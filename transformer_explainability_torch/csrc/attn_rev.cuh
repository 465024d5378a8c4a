// attn_rev_core: the fused backward + LRP relprop of the attention core
// (B5): the kernel and its launcher; the C entry points are attn_rev.cu's.
//
// Replaces transformer_explainability_tpu/ops/pallas_kernels.py:
// attn_rev_core (_attn_rev_kernel), which per (sample, block) loops over
// heads with everything VMEM-resident. Per head it computes
//   forward recompute: dots = q kᵀ (pre-scale), attn = softmax(dots·scale),
//                      out = attn v
//   backward:          g_attn = g_o vᵀ (the attention hook gradient),
//                      g_v = attnᵀ g_o, g_dots = attn ⊙ (g_attn − rowsum(g_attn ⊙ attn)) · scale,
//                      g_q = g_dots k, g_k = g_dotsᵀ q
//   z-rules:           S1 = safe_divide(cam_o, out),
//                      cam1 = attn ⊙ (S1 vᵀ) / 2, cam_v = v ⊙ (attnᵀ S1) / 2,
//                      S2 = safe_divide(cam1, dots)   (pre-scale dots),
//                      cam_q = q ⊙ (S2 k) / 2, cam_k = k ⊙ (S2ᵀ q) / 2
//   gc = mean_h (g_attn ⊙ cam1)⁺
// with g_qkv and cam_qkv in the raw 'n (qkv h d)' layout.
//
// Shapes: qkv (B, n, 3D); g_o, cam_o (B, n, D); out: g_qkv, cam_qkv
// (B, n, 3D), gc (B, n, n). Scratch (allocated by the caller):
// P, G, S2, GCP (B, H, n, n) and S1 (B, H, n, hd).
//
// What bounds it on the H100: operations. At ViT-B/16, B=8 (n = 197, 12
// heads, hd = 64) its ten products are 10 · 8·12·197²·64 FMAs = 4.77 GFLOP,
// 0.0712 ms at the 67 TFLOP/s of FP32 off the tensor cores; the four
// (B, H, n, n) maps that cross between its passes are 15 MB each and stay
// mostly in the 50 MB L2. Exact FP32 must stay off the tensor cores, so the
// float32 products are register tiles, sized by the shared floats each
// thread reads per FMA (a warp's 16-byte shared reads are served a quarter
// warp at a time; rules.cuh). A TPU grid step carries the whole head in
// VMEM; here blocks run in no order, g_v, g_k, cam_v and cam_k are sums
// over query rows, so the kernel runs in two passes and the head mean:
//   1. rows (this file): one block of 4·QT threads per (tile of QT ≤ 64
//      query rows, head, sample), one block an SM (210 KB of shared memory
//      at ViT-B):
//      - B4's tile (attn_fwd.cuh): the scores as 8 × 7 register tiles, the
//        softmax in registers, P·V as 4 × 4 tiles (one chain per output,
//        as B2's), so the probabilities are bitwise B4's and B2's; they go
//        to P, the pre-scale dots to S2's place, and P·V's epilogue forms
//        S1 = safe_divide(cam_o, out);
//      - the V sweep, in the scores' (row, key) layout and key groups (a
//        lane's keys l + 32c, c < 4, then 4 ≤ c < 7 at ViT-B): g_attn =
//        g_o·Vᵀ and t = S1·Vᵀ in one 8 × 4 register tile each (0.31 shared
//        floats per FMA), then per (i, j) cam1 = p·t/2, S2 =
//        safe_divide(cam1, dots), GCP = (g_attn ⊙ cam1)⁺, and after the
//        row sums the softmax backward G = p ⊙ (g_attn − inner)·scale;
//      - the K sweep (K in V's place): g_q = G·K on half the threads and
//        cq = S2·K on the other half, 4 × 8 register tiles (0.375 floats
//        per FMA); cam_q = q ⊙ cq / 2.
//      In bf16 rules (the TP production and split path modes) t and cq run
//      on the tensor cores (mma.sync m16n8k16, float32 sums), t into the
//      shared S tile before the V sweep reads it.
//   2. columns: the column pass B3 and B9 share (rules.cuh), with float32
//      rule products as register tiles in exact FP32.
//   3. head mean: gc = Σ_h GCP / H in a fixed order (no atomics).
// Every sum runs in a fixed order: bitwise repeatable.
//
// Modes (the JAX kernel's attn_mxu and rule_mxu; A for the forward
// recompute and the gradient products, R for the four z-rule products;
// common.cuh): each of the ten products takes its operands unrounded
// (float32), rounded to bf16, or split into bf16×3 parts (three passes
// lo·hi, hi·lo, hi·hi into one chain), with sums in T. A bf16 operand is
// rounded once, in shared memory, where every product that reads it takes
// it in one precision; where two products that share V, K or the columns'
// operands take them in different modes, and for the rule products of the
// double instance (the checks'), each rounds or splits them as they are
// loaded. bf16×3 rule products stay on the CUDA cores in the register
// tiles of the float32 rules (the tensor cores take bf16 rules only): a
// simple first form, three times the FMAs of float32 rules.
#pragma once

#include "attn_fwd.cuh"
#include "rules.cuh"

namespace te {

// Shared memory of the row pass, in elements: B4's tile (the keys padded to
// 16 for the tensor-core steps), then the S tile (t, then S2), the g_o tile
// and the S1 tile.
struct RevRowLayout {
  FwdLayout f;
  size_t s_off, go_off, s1_off, total;
  __host__ __device__ RevRowLayout(int n, int rows) : f(n, 16) {
    s_off = f.tile(rows);
    go_off = s_off + (size_t)rows * f.ldp;
    s1_off = go_off + (size_t)rows * FwdLayout::ldk;
    total = s1_off + (size_t)rows * FwdLayout::ldk;
  }
};

// a compile-time width handed to a generic lambda
template <int N>
struct IntC {
  static constexpr int value = N;
};

// acc = A·K over the keys j < n4 for thread u of a half block: rows
// 4(u/8) … + 3 of A (pitch ldp), columns 4(u%8) … + 3 and 32 + 4(u%8) … + 3
// of K (pitch ldk); NP passes, A's and K's values viewed as VA and VK
// (opnd). Twelve 16-byte reads per 128 FMAs a pass.
template <int NP, int VA, int VK, typename T>
__device__ __forceinline__ void rows_key_tile(const T* A, int ldp,
                                              const T* Ks, int n4, int u,
                                              T (&acc)[4][8]) {
  constexpr int ldk = FwdLayout::ldk;
  const int r0 = 4 * (u / 8), c0 = 4 * (u % 8);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = T(0);
#pragma unroll 1
  for (int ps = 0; ps < NP; ++ps)
  for (int j = 0; j < n4; j += 4) {
    T a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lds4(A + (r0 + i) * ldp + j, a[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) a[i][jj] = opnd<VA, 0>(a[i][jj], ps);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      T k0[4], k1[4];
      lds4(Ks + (j + jj) * ldk + c0, k0);
      lds4(Ks + (j + jj) * ldk + c0 + 32, k1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k0[e] = opnd<VK, 1>(k0[e], ps);
        k1[e] = opnd<VK, 1>(k1[e], ps);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][e] = fma(a[i][jj], k0[e], acc[i][e]);
          acc[i][4 + e] = fma(a[i][jj], k1[e], acc[i][4 + e]);
        }
    }
  }
}

// The row pass (this file's note, pass 1). KC: B4's key groups a lane.
template <typename T, int A, int R, int KC>
__global__ void __launch_bounds__(4 * kFwdMaxRows, 1) attn_rev_rows_kernel(
    const T* __restrict__ qkv, const T* __restrict__ g_o,
    const T* __restrict__ cam_o, T* __restrict__ g_qkv,
    T* __restrict__ cam_qkv, T* __restrict__ P, T* __restrict__ G,
    T* __restrict__ S2, T* __restrict__ GCP, T* __restrict__ S1g, int n,
    int H, int hd, T scale) {
  // the rule products on the tensor cores (bf16 rules in float32)
  constexpr bool MMA = R == kModeBf16 && sizeof(T) == sizeof(float);
  constexpr int ldk = FwdLayout::ldk;
  // the views (opnd) of the products' operands: a bf16 operand lies
  // rounded in shared memory where every product that reads it takes it
  // in bf16, and is rounded as it is loaded where it lies unrounded for
  // another product (V and K: RV, RK); bf16×3 splits as it loads
  constexpr int SA = A == kModeBf16x3 ? kModeBf16x3 : kModeF32;   // g_o, S1 / G, S2
  constexpr int SR = R == kModeBf16x3 ? kModeBf16x3 : kModeF32;
  constexpr int VA = A == kModeBf16 && R != kModeBf16 ? kModeBf16 : SA;   // V and K
  constexpr int VR = R == kModeBf16 && A != kModeBf16 && !MMA ? kModeBf16 : SR;
  constexpr int NPA = kPasses<A>, NPR = MMA ? 1 : kPasses<R>;
  const int NT = blockDim.x, QT = NT / 4, nwarps = NT / kWarp;
  const RevRowLayout lay(n, QT);
  const int n4 = lay.f.n4, ldp = lay.f.ldp;
  T* smem = reinterpret_cast<T*>(te_smem);
  T* Ps = smem + lay.f.p_off(QT);   // P as P·V takes it, g_attn, then G
  T* Vs = smem + lay.f.v_off(QT);   // V, then K
  T* Ss = smem + lay.s_off;         // t (MMA), then S2
  T* Gos = smem + lay.go_off;       // g_o as g_attn takes it
  T* S1s = smem + lay.s1_off;       // S1 as t takes it
  const int t = threadIdx.x, warp = t / kWarp, lane = t % kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * QT;
  const int nr = n - row0 < QT ? n - row0 : QT;
  const int D = H * hd, ld = 3 * D;
  const T* base = qkv + (size_t)b * n * ld + h * hd;
  const bool vec = tile_vec_ok(base, ld, hd);
  const size_t bh = (size_t)b * H + h;
  const size_t tile_o = (bh * n + row0) * n;   // the block's rows of a map
  const T* go_row = g_o + ((size_t)b * n + row0) * D + h * hd;
  const T* co_row = cam_o + ((size_t)b * n + row0) * D + h * hd;
  T* s1_row = S1g + (bh * n + row0) * hd;

  // the g_o tile, and cam_o in the S1 tile (P·V's epilogue divides it
  // there: no load from device memory waits behind the epilogue's stores);
  // zeros past the rows and columns
  for (int idx = t; idx < QT * HD4; idx += NT) {
    const int r = idx / HD4, c = idx % HD4;
    const bool in = r < nr && c < hd;
    Gos[r * ldk + c] = rnd<A == kModeBf16>(in ? go_row[(size_t)r * D + c] : T(0));
    S1s[r * ldk + c] = in ? co_row[(size_t)r * D + c] : T(0);
  }

  // the forward recompute (B4's tile): P to P, the pre-scale dots to S2's
  // place (the QKᵀ rule's denominator until S2 takes it), out = P·V and
  // S1 = safe_divide(cam_o, out) (to S1 and the S1 tile)
  attn_fwd_tile<T, A, KC, true>(
      smem, nullptr, lay.f, qkv, S2, P, n, H, hd, scale,
      [&](int r, int c, T o) {
        const T s1 = safe_divide(S1s[r * ldk + c], o);
        s1_row[(size_t)r * hd + c] = s1;
        S1s[r * ldk + c] = rnd<R == kModeBf16>(s1);
      });
  __syncthreads();
  if constexpr (A == kModeBf16 && R != kModeBf16) {
    // P·V took V rounded in place; t takes it unrounded
    load_tile(Vs, ldk, base + 2 * D, ld, n, hd, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  if constexpr (MMA) {
    // t = S1·Vᵀ on the tensor cores into the S tile: warp w takes rows
    // 16(w % (QT/16)) … + 15 and every other 8-key tile
    const int strips = QT / 16, sr = 16 * (warp % strips);
    uint32_t a1[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* r0 = S1s + (sr + g) * ldk + 16 * kk + 2 * t4;
      const float* r1 = r0 + 8 * ldk;
      a1[kk][0] = pack_bf16x2(r0[0], r0[1]);
      a1[kk][1] = pack_bf16x2(r1[0], r1[1]);
      a1[kk][2] = pack_bf16x2(r0[8], r0[9]);
      a1[kk][3] = pack_bf16x2(r1[8], r1[9]);
    }
    for (int kt = warp / strips; kt < n4 / 8; kt += 2) {
      float dacc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* vr = Vs + (8 * kt + g) * ldk + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t bf[2] = {pack_bf16x2(vr[16 * kk], vr[16 * kk + 1]),
                                pack_bf16x2(vr[16 * kk + 8], vr[16 * kk + 9])};
        mma_bf16_16816(dacc, a1[kk], bf);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ss[(sr + g + 8 * (i >> 1)) * ldp + 8 * kt + 2 * t4 + (i & 1)] =
            dacc[i];
    }
    __syncthreads();
  }

  // the V sweep: warp w rows 8w … 8w + 7, lane l the keys of the scores
  // (l + 32c, c < KC, in tiles of 32·KC keys), W of them at a time
  const bool live = 8 * warp < nr;
  T inner[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) inner[i] = T(0);
  auto sweep = [&](auto width, int jb) {
    constexpr int W = decltype(width)::value;
    if (jb >= n) return;
    T ga[8][W], tt[8][W];
    const T* vp[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int j = jb + lane + kWarp * c;
      vp[c] = Vs + (size_t)(j < n ? j : n - 1) * ldk;
#pragma unroll
      for (int i = 0; i < 8; ++i) ga[i][c] = tt[i][c] = T(0);
    }
    // g_attn's NPA passes and t's NPR beside them (bf16×3: three)
#pragma unroll 1
    for (int ps = 0; ps < (NPA > NPR ? NPA : NPR); ++ps)
#pragma unroll 1
    for (int d = 0; d < HD4; d += 4) {
      T v[W][4], vg[W][4];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        lds4(vp[c] + d, v[c]);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          vg[c][dd] = opnd<VA, 1>(v[c][dd], ps);
          v[c][dd] = opnd<VR, 1>(v[c][dd], ps);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (ps < NPA) {
          T go[4];
          lds4(Gos + (8 * warp + i) * ldk + d, go);
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) go[dd] = opnd<SA, 0>(go[dd], ps);
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
#pragma unroll
            for (int c = 0; c < W; ++c)
              ga[i][c] = fma(go[dd], vg[c][dd], ga[i][c]);
        }
        if constexpr (!MMA) {
          if (ps < NPR) {
            T s1[4];
            lds4(S1s + (8 * warp + i) * ldk + d, s1);
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) s1[dd] = opnd<SR, 0>(s1[dd], ps);
#pragma unroll
            for (int dd = 0; dd < 4; ++dd)
#pragma unroll
              for (int c = 0; c < W; ++c)
                tt[i][c] = fma(s1[dd], v[c][dd], tt[i][c]);
          }
        }
      }
    }
    // per (i, j): the AV rule's cam1, the QKᵀ rule's S2, (g_attn ⊙ cam1)⁺;
    // g_attn waits in the P tile for the row sums
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int j = jb + lane + kWarp * c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * warp + i;
        T* sp = Ss + r * ldp + j;
        T* gp = Ps + r * ldp + j;
        if (r < nr && j < n) {
          const size_t o = tile_o + (size_t)r * n + j;
          const T p = P[o];
          T tv;
          if constexpr (MMA) tv = *sp;
          else tv = tt[i][c];
          inner[i] = fma(ga[i][c], p, inner[i]);
          const T cam1 = p * tv * T(0.5);
          const T gcv = ga[i][c] * cam1;
          GCP[o] = gcv > T(0) ? gcv : T(0);
          const T s2 = safe_divide(cam1, S2[o]);
          S2[o] = s2;
          *sp = rnd<R == kModeBf16>(s2);
          *gp = ga[i][c];
        } else if (j < n4) {
          *sp = T(0);
          *gp = T(0);
        }
      }
    }
  };
  if (live) {
    for (int j0 = 0; j0 < n; j0 += KC * kWarp) {
      // two steps of 4 and KC − 4 keys a lane in float32; of 2 in double
      // (8 × W tiles of g_attn and t: 0.31 shared floats per FMA at W = 4)
      if constexpr (sizeof(T) == sizeof(float)) {
        sweep(IntC<4>{}, j0);
        sweep(IntC<KC - 4>{}, j0 + 4 * kWarp);
      } else if constexpr (A == kModeBf16x3 || R == kModeBf16x3) {
        // double with a bf16×3 product: one key group a step (its split
        // operands spilled at two); each output's sums keep their order
        for (int c = 0; c < KC; ++c) sweep(IntC<1>{}, j0 + c * kWarp);
      } else {
        sweep(IntC<2>{}, j0);
        sweep(IntC<2>{}, j0 + 2 * kWarp);
        sweep(IntC<2>{}, j0 + 4 * kWarp);
        sweep(IntC<KC - 6>{}, j0 + 6 * kWarp);
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        inner[i] += __shfl_xor_sync(0xffffffffu, inner[i], o);
    // the softmax backward G = p ⊙ (g_attn − inner) · scale, to G and (as
    // g_q takes it) over g_attn
    for (int j0 = 0; j0 < n; j0 += KC * kWarp)
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int j = j0 + lane + kWarp * c;
        T pv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          pv[i] = T(0);
          if (8 * warp + i < nr && j < n)
            pv[i] = P[tile_o + (size_t)(8 * warp + i) * n + j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 8 * warp + i;
          if (r < nr && j < n) {
            T* gp = Ps + r * ldp + j;
            const T gd = pv[i] * (*gp - inner[i]) * scale;
            G[tile_o + (size_t)r * n + j] = gd;
            *gp = rnd<A == kModeBf16>(gd);
          }
        }
      }
  }
  __syncthreads();   // V is consumed

  // the K sweep: K in V's place (its rows past n and columns past hd are
  // zero already), rounded there where both products take it as bf16
  load_tile(Vs, ldk, base + D, ld, n, hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (A == kModeBf16 && R == kModeBf16) {
    for (int idx = t; idx < n4 * ldk; idx += NT) Vs[idx] = rnd<true>(Vs[idx]);
    __syncthreads();
  }
  const int half = NT / 2, u = t % half;
  const size_t row_q = ((size_t)b * n + row0) * ld + h * hd;
  if (t < half || !MMA) {
    // g_q = G·K (threads [0, half)), cq = S2·K (the others, float32 rules)
    const bool first = t < half;
    T acc[4][8];
    if (first)
      rows_key_tile<NPA, SA, VA>(Ps, ldp, Vs, n4, u, acc);
    else
      rows_key_tile<NPR, SR, VR>(Ss, ldp, Vs, n4, u, acc);
    const int r0 = 4 * (u / 8), c0 = 4 * (u % 8);
    // cam_q's q values, all loaded before any store
    T qv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + (e < 4 ? e : 28 + e);
        qv[i][e] = T(0);
        if (!first && r0 + i < nr && c < hd)
          qv[i][e] = qkv[row_q + (size_t)(r0 + i) * ld + c];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= nr) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + (e < 4 ? e : 28 + e);
        if (c >= hd) continue;
        const size_t o = row_q + (size_t)(r0 + i) * ld + c;
        if (first)
          g_qkv[o] = acc[i][e];
        else
          cam_qkv[o] = qv[i][e] * acc[i][e] * T(0.5);
      }
    }
  } else if constexpr (MMA) {
    // cq = S2·K on the tensor cores: warp w of the second half takes rows
    // 16(w − nwarps/2) … + 15 and all 64 columns
    const int sr = 16 * (warp - nwarps / 2);
    float cq[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) cq[nt][i] = 0.f;
    for (int k0 = 0; k0 < n4; k0 += 16) {
      const float* r0 = Ss + (sr + g) * ldp + k0 + 2 * t4;
      const float* r1 = r0 + 8 * ldp;
      const uint32_t af[4] = {pack_bf16x2(r0[0], r0[1]),
                              pack_bf16x2(r1[0], r1[1]),
                              pack_bf16x2(r0[8], r0[9]),
                              pack_bf16x2(r1[8], r1[9])};
      const float* kr = Vs + (k0 + 2 * t4) * ldk + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kc = kr + 8 * nt;
        const uint32_t bf[2] = {pack_bf16x2(kc[0], kc[ldk]),
                                pack_bf16x2(kc[8 * ldk], kc[9 * ldk])};
        mma_bf16_16816(cq[nt], af, bf);
      }
    }
    float qv[8][4];   // q, all loaded before any store
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sr + g + 8 * (i >> 1), c = 8 * nt + 2 * t4 + (i & 1);
        qv[nt][i] = r < nr && c < hd ? qkv[row_q + (size_t)r * ld + c] : 0.f;
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sr + g + 8 * (i >> 1), c = 8 * nt + 2 * t4 + (i & 1);
        if (r < nr && c < hd)
          cam_qkv[row_q + (size_t)r * ld + c] = qv[nt][i] * cq[nt][i] * 0.5f;
      }
  }
}

// Rows a block: 64 (n rounded up if less), fewer where the shared memory
// asks; a multiple of 16 where the rule products run on the tensor cores.
template <typename T, int A, int R>
int attn_rev_launch(const T* qkv, const T* g_o, const T* cam_o, T* g_qkv,
                    T* cam_qkv, T* gc, T* P, T* G, T* S2, T* GCP, T* S1,
                    int B, int n, int H, int hd, double scale,
                    cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHeadDim || n < 1) return (int)cudaErrorInvalidValue;
  constexpr int step = R == kModeBf16 && sizeof(T) == sizeof(float) ? 16 : 8;
  const size_t limit = (size_t)max_smem_optin();
  const int up = (n + step - 1) / step * step;
  int rows = up < kFwdMaxRows ? up : kFwdMaxRows;
  while (rows > step && sizeof(T) * RevRowLayout(n, rows).total > limit)
    rows -= step;
  const size_t smem = sizeof(T) * RevRowLayout(n, rows).total;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  auto kern = n <= 7 * kWarp ? attn_rev_rows_kernel<T, A, R, 7>
                             : attn_rev_rows_kernel<T, A, R, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, H, B);
  TE_LAUNCH(kern, grid, 4 * rows, smem, stream)(
      qkv, g_o, cam_o, g_qkv, cam_qkv, P, G, S2, GCP, S1, n, H, hd,
      (T)scale);
  TE_TRY((int)cudaGetLastError());
  return attn_rev_cols<A, T, R>(qkv, g_o, P, G, S2, S1, GCP, g_qkv,
                                  cam_qkv, gc, B, n, H, hd, stream);
}

// the instance of the (attention, rule) mode pair (A, r): r 0 = float32,
// 1 = bf16, 2 = bf16×3. Defined for each attention mode A in a translation
// unit of its own (attn_rev_f32.cu, attn_rev_bf16.cu, attn_rev_bf16x3.cu),
// so that nvcc builds the nine pairs' instances in parallel.
template <typename T>
using AttnRevLaunch = int (*)(const T*, const T*, const T*, T*, T*, T*, T*,
                              T*, T*, T*, T*, int, int, int, int, double,
                              cudaStream_t);
template <typename T, int A>
AttnRevLaunch<T> attn_rev_rule(int r);

}  // namespace te
