"""Which products of B6's MLP half (``csrc/mlp_rev.cuh``, shared with B3)
carry the float32 error of its ``Rm`` at ViT-L widths (fault C5).

    python3 experiments/torch_c5_gemm.py [--seeds 1 2 3 10 13 0 4]

For each draw of ``chip_smoke.py``'s C5 inputs (its seed numbering, ViT-L
widths (8, 197, 1024, 4096), bf16×3 MLP products, the rule mode of
``--rule``) it prints the 2-norm error of ``Rm`` against the plain float64
version, relative to its norm, of: the kernel (``K.mlp_rev_core``); the
plain float32 version; and the plain float32 version with some of its
products taken from the GEMM core alone (``K.gemm_core``, the core every
product of the kernel runs on): the rule denominators |x|·|W|ᵀ (all-
positive sums, "abs"), the MLP's forward and backward products ("mlp",
in the MLP mode), the rules' numerators S·W and S·|W| ("dual", in the rule
mode), every product but the denominators ("other") or all of them, each in
the core's one-chain bf16×3 mode; and the MLP products in the promoted
mode the kernels run them in since C5's repair ("mlp rn": ``csrc/gemm.cuh``
kBf16x3Rn, mode 2 of the core alone). Where the kernel's error is the error
of the core's products, the matching row reproduces it and the others say
which products carry it. Needs a CUDA card; imports no JAX.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from transformer_explainability_torch.ops import (  # noqa: E402
    block_math as bm, kernels as K, precision as prec)
from transformer_explainability_torch.ops.relprop import (  # noqa: E402
    safe_divide)

EPS = 1e-6
B, N, D, M = 8, 197, 1024, 4096


def inputs(seed, mlp, dev):
    """chip_smoke.py's c5_measurement draw ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(2000 + seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64)

    w1 = prec.prepare_weight(randn(M, D) / D ** 0.5, mlp)
    w2 = prec.prepare_weight(randn(D, M) / M ** 0.5, mlp)
    vecs = (1.0 + 0.1 * randn(D), 0.1 * randn(D), 0.1 * randn(M),
            0.1 * randn(D))
    z = torch.zeros(1, device=dev)

    def params(ln2s, ln2b, b1, b2):
        return bm.BlockParams(z, z, ln2s, ln2b, z, z, b1, b2, None, None,
                              w1, w2)

    a64 = (4.0 + 0.5 * randn(B, N, D), randn(B, N, D), randn(B, N, D))
    return params(*vecs), params(*(v.float() for v in vecs)), a64


def mlp_half(x_mid, g_out, R, p, mlp, rule, core):
    """bm.mlp_rev_math in float32 with the product kinds in ``core``
    ("abs": the |x|·|W|ᵀ denominators, "mlp": the MLP's products, "dual":
    the rules' numerators; "mlp rn": the MLP's products in the promoted
    mode) taken from the GEMM core; returns Rm."""
    def mm(a, w, mode, wt, kind, absolute=False):
        a2 = a.reshape(-1, a.shape[-1])
        if kind == "mlp" and "mlp rn" in core:
            out = K._launch_gemm(K._lib(), a2.contiguous(), w, 2, wt,
                                 absolute, False, -1, K._stream(a2))
        elif kind in core:
            out = K.gemm_core(a2.contiguous(), w, mode, wt, absolute)
        else:
            ww = prec.kabs(w) if absolute else tuple(w)
            out = prec.kdot(a2.abs() if absolute else a2,
                            prec.transpose(ww) if wt else ww, mode)
        return out.reshape(*a.shape[:-1], out.shape[-1])

    def rule_(x, w, Rr, y_pre):
        axw = mm(x, w, rule, True, "abs", absolute=True)
        S = safe_divide(Rr, 0.5 * (y_pre + axw))
        return 0.5 * (x * mm(S, w, rule, False, "dual")
                      + x.abs() * mm(S, prec.PreparedWeight(prec.kabs(w)),
                                     rule, False, "dual"))

    xn2, mu, inv = bm.ln_fwd(x_mid, p.ln2s, p.ln2b, EPS)
    fc1_pre = mm(xn2, p.w1, mlp, True, "mlp")
    h1 = fc1_pre + p.b1
    hg = bm.gelu_exact(h1)
    fc2_pre = mm(hg, p.w2, mlp, True, "mlp")
    Ca, Cb = bm.add_rule_math(x_mid, fc2_pre + p.b2, R)
    R2 = rule_(hg, p.w2, Cb, fc2_pre)
    R2b = rule_(xn2, p.w1, R2, fc1_pre)
    return x_mid * safe_divide(Ca + R2b, x_mid)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1, 2, 3, 10, 13, 0, 4])
    ap.add_argument("--rule", default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_c5_gemm: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mlp, rule = "tensorfloat32", args.rule
    for seed in args.seeds:
        q64, q32, a64 = inputs(seed, mlp, dev)
        a32 = tuple(t.float() for t in a64)
        p64 = K.mlp_rev_core_plain(*a64, q64, EPS, mlp, rule)[1]

        def rel(t):
            return ((t.double() - p64).norm() / p64.norm()).item()

        row = {"kernel": rel(K.mlp_rev_core(*a32, q32, EPS, mlp, rule)[1]),
               "plain f32": rel(K.mlp_rev_core_plain(*a32, q32, EPS, mlp,
                                                     rule)[1])}
        for label, core in (("core abs", ("abs",)), ("core mlp", ("mlp",)),
                            ("core dual", ("dual",)),
                            ("core other", ("mlp", "dual")),
                            ("core all", ("abs", "mlp", "dual")),
                            ("core mlp rn", ("mlp rn",))):
            row[label] = rel(mlp_half(*a32, q32, mlp, rule, core))
        print(f"c5 products seed {seed} (tf32 / {rule}): " + ", ".join(
            f"{k} {v:.3e}" for k, v in row.items()))


if __name__ == "__main__":
    main()
