// attn_rev_core's C entry points (B5; the kernel, its design and what it
// replaces: attn_rev.cuh).
#include "attn_rev.cuh"

// Plain C entry points. attn_mode (the recompute and gradient products)
// and rule_mode (the z-rule products): 0 = float32, 1 = bf16, 2 = bf16×3.
#define TE_ATTN_REV_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* qkv, const void* g_o, const void* cam_o,   \
                      void* g_qkv, void* cam_qkv, void* gc, void* P,         \
                      void* G, void* S2, void* GCP, void* S1, int B, int n,  \
                      int H, int hd, double scale, int attn_mode,            \
                      int rule_mode, void* stream) {                         \
    using namespace te;                                                      \
    if (attn_mode < kModeF32 || attn_mode > kModeBf16x3 ||                   \
        rule_mode < kModeF32 || rule_mode > kModeBf16x3)                     \
      return (int)cudaErrorInvalidValue;                                     \
    const auto launch =                                                      \
        attn_mode == kModeBf16x3 ? attn_rev_rule<T, kModeBf16x3>(rule_mode)  \
        : attn_mode              ? attn_rev_rule<T, kModeBf16>(rule_mode)    \
                                 : attn_rev_rule<T, kModeF32>(rule_mode);    \
    return launch(                                                           \
        static_cast<const T*>(qkv), static_cast<const T*>(g_o),              \
        static_cast<const T*>(cam_o), static_cast<T*>(g_qkv),                \
        static_cast<T*>(cam_qkv), static_cast<T*>(gc), static_cast<T*>(P),   \
        static_cast<T*>(G), static_cast<T*>(S2), static_cast<T*>(GCP),       \
        static_cast<T*>(S1), B, n, H, hd, scale,                             \
        static_cast<cudaStream_t>(stream));                                  \
  }

TE_ATTN_REV_ENTRY(te_attn_rev_f32, float)
TE_ATTN_REV_ENTRY(te_attn_rev_f64, double)
