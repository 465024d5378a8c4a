// B5's instances with bf16 recompute and gradient products, each rule
// mode, float and double (attn_rev.cuh; attn_rev.cu dispatches to them).
#include "attn_rev.cuh"

namespace te {

template <typename T, int A>
AttnRevLaunch<T> attn_rev_rule(int r) {
  return r == kModeBf16x3 ? attn_rev_launch<T, A, kModeBf16x3>
         : r              ? attn_rev_launch<T, A, kModeBf16>
                          : attn_rev_launch<T, A, kModeF32>;
}

template AttnRevLaunch<float> attn_rev_rule<float, kModeBf16>(int);
template AttnRevLaunch<double> attn_rev_rule<double, kModeBf16>(int);

}  // namespace te
