"""B3 (``csrc/block_rev.cu``) against its plain version at the ragged shape
over many draws of its inputs.

    python3 experiments/torch_b3_ragged_seeds.py [--seeds 32]

``chip_smoke.py`` holds B3's float32 outputs (g_in, R_in, gc) at the ragged
shape (2, 29, 3, 8) to the plain version in float64, in both presets' modes,
on one draw of inputs. This script makes the inputs as ``chip_smoke.py``'s
``block_case`` does, from seeds 0..N-1 (a generator each), and prints for
every (preset, seed, output):

  err     max|k32 - p64|, the kernel in float32 against the plain version
          in float64 in the same product modes;
  plain   max|p32 - p64|, the plain version in float32;
  limit   chip_smoke.py's rule, 10·plain + 1e-6·max|p64|, and how many
          elements exceed it and where the largest error is (b, token, col);
  norm    |k32 - p64| / |p64| against 10× the plain float32 version's;
  ulp     the largest max|p32' - p64| of the plain float32 version over 8
          draws of inputs moved by one float32 ulp at random: how far this
          output moves when its float32 inputs do, by the plain version's
          own arithmetic.

For an output that fails the rule, the draw is rerun from those 8 moved
inputs, the kernel and the plain float32 version each against the plain
float64 version of the moved inputs, by the same rule: ``moved`` counts the
reruns the kernel passes. A fault (a wrong element, a ragged edge) fails
every rerun; an operand whose bf16 rounding sits on a knife edge, so that
another float32 order rounds it the other way, passes most. The plain
float32 version's own flips show as draws where its error jumps and the
kernel's follows it. The last line sums the draws. Needs a CUDA card;
imports no JAX.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from transformer_explainability_torch.models.vit import VIT_BASE_16_224  # noqa: E402
from transformer_explainability_torch.ops import block_math as bm  # noqa: E402
from transformer_explainability_torch.ops import kernels as K  # noqa: E402
from transformer_explainability_torch.ops import precision as prec  # noqa: E402

SHAPE = (2, 29, 3, 8)   # chip_smoke.py's ragged shape: b, n, heads, hd
MODES = {"production": ("tensorfloat32", "float32", "bfloat16", "bfloat16"),
         "bfloat16": ("bfloat16", "bfloat16", "bfloat16", None)}
NAMES = ("g_in", "R_in", "gc")


def case(seed, base, dev):
    """chip_smoke.py's block_case from a generator of its own."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, n, h, hd = SHAPE
    D, M = h * hd, 4 * h * hd

    def randn(*shape, offset=0.0):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64) + offset

    def w(o, i):
        return randn(o, i) / i ** 0.5

    def vec(k, centre=0.0):
        return centre + 0.1 * randn(k)

    ws = [prec.prepare_weight(t, base)
          for t in (w(3 * D, D), w(D, D), w(M, D), w(D, M))]
    vecs = [vec(D, 1.0), vec(D), vec(D, 1.0), vec(D), vec(3 * D), vec(D),
            vec(M), vec(D)]
    p64 = bm.BlockParams(*vecs, *ws)
    p32 = bm.BlockParams(*[v.float() for v in vecs], *ws)
    x = randn(b, n, D, offset=0.5)
    g_out, R = randn(b, n, D), randn(b, n, D)
    return p64, p32, x, g_out, R


def ulp_move(t, gen):
    """t with each element moved one float32 ulp up, down or not at all."""
    s = torch.randint(-1, 2, t.shape, generator=gen, device=t.device)
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    down = torch.nextafter(t, torch.full_like(t, float("-inf")))
    return torch.where(s > 0, up, torch.where(s < 0, down, t))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_b3_ragged_seeds: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    b, n, h, hd = SHAPE
    eps = VIT_BASE_16_224.block_ln_eps
    fails, norm_fails, beyond_ulp, total, passed_moved = 0, 0, 0, 0, 0
    for preset, (mxu, attn, rule, mlp) in MODES.items():
        for seed in range(args.seeds):
            p64, p32, x, g_out, R = case(seed, mxu, dev)
            fargs = (h, hd, eps, mxu, attn, mlp, True, True)
            f64 = bm.block_fwd_core_plain(x, p64, *fargs)
            a64 = (x, f64[1], f64[2], g_out, R)
            a32 = tuple(t.float() for t in a64)
            s64, s32 = f64[3:], tuple(t.float() for t in f64[3:])
            rargs = (h, hd, eps, mxu, attn, rule, mlp)
            k32 = K.block_rev_core(*a32, p32, *rargs, saved=s32)
            r64 = bm.block_rev_core_plain(*a64, p64, *rargs, saved=s64)
            r32 = bm.block_rev_core_plain(*a32, p32, *rargs, saved=s32)
            gen = torch.Generator(device=dev).manual_seed(10_000 + seed)
            moved, reruns = [], []
            for _ in range(8):
                m32 = tuple(ulp_move(t, gen) for t in a32)
                ms32 = tuple(ulp_move(t, gen) for t in s32)
                moved.append(bm.block_rev_core_plain(*m32, p32, *rargs,
                                                     saved=ms32))
                reruns.append((m32, ms32))
            torch.cuda.synchronize()
            for i, name in enumerate(NAMES):
                k, p, q = k32[i].double(), r64[i], r32[i].double()
                diff = (k - p).abs()
                err, plain = diff.max().item(), (q - p).abs().max().item()
                limit = 10.0 * plain + 1e-6 * p.abs().max().item()
                over = int((diff > limit).sum().item())
                where = tuple(int(v) for v in torch.unravel_index(
                    diff.argmax(), diff.shape))
                pn = p.norm().item()
                nk, npl = (k - p).norm().item() / pn, (q - p).norm().item() / pn
                ulp = max((m[i].double() - p).abs().max().item()
                          for m in moved)
                total += 1
                fails += err > limit
                norm_fails += nk > 10.0 * npl + 1e-6
                beyond_ulp += err > limit and err > ulp
                rerun = ""
                if err > limit:
                    ok = 0
                    for (m32, ms32), mq in zip(reruns, moved):
                        m64 = bm.block_rev_core_plain(
                            *(t.double() for t in m32), p64, *rargs,
                            saved=tuple(t.double() for t in ms32))[i]
                        mk = K.block_rev_core(*m32, p32, *rargs,
                                              saved=ms32)[i].double()
                        mq = mq[i].double()
                        lim = (10.0 * (mq - m64).abs().max().item()
                               + 1e-6 * m64.abs().max().item())
                        ok += (mk - m64).abs().max().item() <= lim
                    passed_moved += ok
                    rerun = f"; moved {ok}/{len(reruns)} pass"
                print(f"{preset} seed {seed:2d} {name:4s}: err {err:.3e} "
                      f"plain {plain:.3e} limit {limit:.3e} "
                      f"{'FAIL' if err > limit else 'ok'} ({over} over, "
                      f"largest at {where}); norm {nk:.3e} vs "
                      f"{10.0 * npl + 1e-6:.3e}; ulp {ulp:.3e}{rerun}")
    print(f"summary: {total} outputs over {args.seeds} draws x "
          f"{len(MODES)} presets; above the largest-error rule {fails}, "
          f"above the 2-norm rule {norm_fails}, above the rule and beyond "
          f"the plain version's 1-ulp moves {beyond_ulp}; their reruns "
          f"from moved inputs passed {passed_moved} of {8 * fails}")


if __name__ == "__main__":
    main()
