"""B2's attention anchors from two checkouts of the port, compared bitwise.

    python3 experiments/torch_b2_anchors.py --out build/b2_new.pt
    python3 experiments/torch_b2_anchors.py --root build/parent \\
        --out build/b2_old.pt
    python3 experiments/torch_b2_anchors.py --compare build/b2_old.pt \\
        build/b2_new.pt

The first two forms run ``block_fwd_core`` once at ViT-B/16 B=8 in the
``production`` and ``bfloat16`` presets' modes, on inputs from a seeded
generator (the same in every checkout), with the port imported from
``--root`` (default: this checkout), and save its ``out_m``, ``dots`` and
``probs`` outputs (about 60 MB: keep them under ``build/``). ``--compare``
prints, for each preset and output, whether the two files hold the same
bits, how many elements differ, and the largest difference. Needs a CUDA
card; imports no JAX.
"""

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("out_m", "dots", "probs")       # block_fwd_core outputs 2, 5, 6


def run(root: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from transformer_explainability_torch.explain.generator import (
        precision_kwargs)
    from transformer_explainability_torch.models.vit import VIT_BASE_16_224
    from transformer_explainability_torch.ops import block_math as bm
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops import precision as P
    from transformer_explainability_torch.ops.precision import mxu_name
    import transformer_explainability_torch as te
    print(f"port imported from {os.path.dirname(te.__file__)}")
    cfg, dev = VIT_BASE_16_224, torch.device("cuda")
    D, h, hd, M, n = (cfg.embed_dim, cfg.num_heads, cfg.head_dim,
                      cfg.mlp_dim, cfg.num_tokens)
    saved = {}
    for preset in ("production", "bfloat16"):
        prec = precision_kwargs(preset)
        mxu = mxu_name(prec.get("matmul_precision"))
        attn = mxu_name(prec.get("attn_precision",
                                 prec.get("matmul_precision")))
        mlp = mxu_name(prec.get("mlp_precision", prec.get("matmul_precision")))
        gen = torch.Generator(device=dev).manual_seed(5)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        ws = [P.prepare_weight(randn(o, i).double() / i ** 0.5, mxu)
              for o, i in ((3 * D, D), (D, D), (M, D), (D, M))]
        vecs = [1.0 + 0.1 * randn(D), 0.1 * randn(D), 1.0 + 0.1 * randn(D),
                0.1 * randn(D), 0.1 * randn(3 * D), 0.1 * randn(D),
                0.1 * randn(M), 0.1 * randn(D)]
        p = bm.BlockParams(*vecs, *ws)
        x = randn(8, n, D) + 0.5
        outs = K.block_fwd_core(x, p, h, hd, cfg.block_ln_eps, mxu, attn, mlp,
                                save_attn=True)
        torch.cuda.synchronize()
        for i, name in zip((2, 5, 6), NAMES):
            saved[f"{preset} {name}"] = outs[i].cpu()
    torch.save(saved, out)
    print(f"saved {len(saved)} tensors to {out}")


def compare(a: str, b: str) -> None:
    ta, tb = torch.load(a), torch.load(b)
    for key in ta:
        x, y = ta[key], tb[key]
        same = torch.equal(x.view(torch.int32), y.view(torch.int32))
        diff = int((x.view(torch.int32) != y.view(torch.int32)).sum())
        print(f"{key}: {'bitwise equal' if same else 'differ'}; "
              f"{diff} of {x.numel()} elements differ, max |a-b| "
              f"{(x - y).abs().max().item():.3e}, max |a| "
              f"{x.abs().max().item():.3e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[{card}]")
    run(args.root, args.out)


if __name__ == "__main__":
    main()
