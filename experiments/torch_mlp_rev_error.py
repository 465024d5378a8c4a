"""Where the float32 error of the MLP reverse kernel ``mlp_rev_core`` comes
from, on one CUDA card, at ViT-B/16 B=8 (R = 1576 rows, D=768, M=3072).

    python3 experiments/torch_mlp_rev_error.py [--seed 1234]

For both (MLP, rule) mode pairs of ``chip_smoke.py``'s check (bf16/bf16 and
bf16x3/bf16), on the same seeded inputs (x_mid around 4, as there), prints
for the kernel's float32 outputs and the plain float32 version's, each
against the plain float64 version: the largest error, the 2-norm of the
error relative to the result's, the mean error relative to the mean
magnitude (a bias), and the values where the kernel's error is largest. Then
the same for the recompute products the kernel shares with
``mlp_rev_tp_phase1`` (the same GEMM-core instances: fc1, fc2, the
all-positive |hg|·|W2| denominator and the g_xn2 backward product), and the
plain float32 version fed with those kernel-made fc1/fc2 anchors: if it lands
where the kernel lands, the kernel's rule and backward code agree with the
plain version and the difference is in the recomputed anchors. Needs no JAX.
"""

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stats(name, k, p32, p64):
    ek, ep = k.double() - p64, p32.double() - p64
    i = ek.abs().argmax()
    scale = p64.abs().mean()
    print(f"{name}: max err kernel {ek.abs().max():.3e} plain f32 "
          f"{ep.abs().max():.3e}; 2-norm rel kernel "
          f"{ek.norm() / p64.norm():.3e} plain f32 {ep.norm() / p64.norm():.3e};"
          f" bias kernel {ek.mean() / scale:.3e} plain f32 "
          f"{ep.mean() / scale:.3e}; at the kernel's largest error f64 "
          f"{p64.flatten()[i]:.5e} kernel {k.flatten()[i]:.5e} plain f32 "
          f"{p32.flatten()[i]:.5e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from transformer_explainability_torch.ops import block_math as bm
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops import precision as prec

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    eps = 1e-6

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64)

    b, n, D, M = 8, 197, 768, 3072
    for mlp in ("bfloat16", "tensorfloat32"):
        print(f"== MLP products {mlp}, rule products bfloat16")
        w1 = prec.prepare_weight(randn(M, D) / D ** 0.5, mlp)
        w2 = prec.prepare_weight(randn(D, M) / M ** 0.5, mlp)
        vecs = (1 + 0.1 * randn(D), 0.1 * randn(D), 0.1 * randn(M),
                0.1 * randn(D))                   # ln2s, ln2b, b1, b2
        z = torch.zeros(1, device=dev)

        def params(v):
            return bm.BlockParams(z, z, v[0], v[1], z, z, v[2], v[3], None,
                                  None, w1, w2)

        p64, p32 = params(vecs), params([v.float() for v in vecs])
        a64 = (4 + 0.5 * randn(b, n, D), randn(b, n, D), randn(b, n, D))
        a32 = tuple(t.float() for t in a64)
        k = K.mlp_rev_core(*a32, p32, eps, mlp, "bfloat16")
        q64 = K.mlp_rev_core_plain(*a64, p64, eps, mlp, "bfloat16")
        q32 = K.mlp_rev_core_plain(*a32, p32, eps, mlp, "bfloat16")
        for i, nm in enumerate(["g_mid", "Rm"]):
            stats(nm, k[i], q32[i], q64[i])
        v32 = [v.float() for v in vecs[:3]]
        ph = K.mlp_rev_tp_phase1(a32[0], a32[1], *v32, w1, w2, eps, mlp,
                                 "bfloat16")
        ph64 = K.mlp_rev_tp_phase1_plain(a64[0], a64[1], *vecs[:3], w1, w2,
                                         eps, mlp, "bfloat16")
        ph32 = K.mlp_rev_tp_phase1_plain(a32[0], a32[1], *v32, w1, w2, eps,
                                         mlp, "bfloat16")
        for i, nm in enumerate(["fc1_pre", "fc2_pre", "|hg|.|W2|",
                                "g_xn2"]):
            stats(f"GEMM core {nm}", ph[i], ph32[i], ph64[i])
        r = bm.mlp_rev_math(*a32, p32, eps=eps, mxu=mlp, rule_mxu="bfloat16",
                            saved_mlp=(ph[0], ph[1]))
        print(f"plain f32 from the kernel-made anchors vs the kernel: Rm max "
              f"{(k[1] - r[1]).abs().max().item():.3e}, g_mid max "
              f"{(k[0] - r[0]).abs().max().item():.3e}")
        stats("plain f32 from the kernel-made anchors, Rm", r[1], q32[1],
              q64[1])


if __name__ == "__main__":
    main()
