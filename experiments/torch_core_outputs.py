"""The outputs of every layer kernel on the GEMM core, from two checkouts of
the port, compared bitwise.

    python3 experiments/torch_core_outputs.py --out build/core_new.pt
    python3 experiments/torch_core_outputs.py --root build/parent \\
        --out build/core_old.pt
    python3 experiments/torch_core_outputs.py --compare build/core_old.pt \\
        build/core_new.pt

The first two forms run each kernel that launches the GEMM core
(``csrc/gemm.cuh``) once at its main shapes: B2 ``block_fwd_core``, B3
``block_rev_core``, B6 ``mlp_rev_core`` and the tensor-parallel MLP
phases B10a / B10b at k = 1 at ViT-B/16 B=8, and B7
``bert_layer_fwd_core``, B8 ``bert_out_rev_core`` and B9
``bert_attn_rev_core`` at BERT-base B=8, S=512, in the ``production`` and
``bfloat16`` presets' modes. Each call and its inputs (a seeded generator)
are ``layer_call`` of ``experiments/torch_profile_vit.py`` in the checkout
``--root`` (default: this one), whose port it imports, so two checkouts
draw the same inputs. It saves every output (about 1 GB: keep them under
``build/``). ``--compare`` prints, for each preset, kernel and output,
whether the two files hold the same bits, how many elements differ and the
largest difference. Needs a CUDA card; imports no JAX.
"""

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("b2", "b3", "b6", "b10a", "b10b", "b7", "b8", "b9")
PRESETS = ("production", "bfloat16")


def run(root: str, out: str) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "experiments")]
    from torch_profile_vit import layer_call
    from transformer_explainability_torch.explain.generator import (
        precision_kwargs)
    import transformer_explainability_torch as te
    print(f"port imported from {os.path.dirname(te.__file__)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    saved = {}
    for preset in PRESETS:
        for which in KERNELS:
            label, call = layer_call(which, dev, 512, precision_kwargs(preset))
            outs = call()
            torch.cuda.synchronize()
            outs = outs if isinstance(outs, tuple) else (outs,)
            for i, t in enumerate(outs):
                if torch.is_tensor(t):
                    saved[f"{preset} {which} {i}"] = t.cpu()
            print(f"{preset}: {label}: {len(outs)} outputs")
            del outs, call
            torch.cuda.empty_cache()
    torch.save(saved, out)
    print(f"saved {len(saved)} tensors to {out}")


def compare(a: str, b: str) -> None:
    ta, tb = torch.load(a), torch.load(b)
    equal = 0
    for key in ta:
        x, y = ta[key], tb[key]
        bits = torch.int32 if x.element_size() == 4 else torch.int64
        ne = x.view(bits) != y.view(bits)
        same = not bool(ne.any())
        equal += same
        d = (x.double() - y.double()).abs()
        d = d[d == d]                        # NaN == NaN bitwise above
        verdict = "bitwise equal" if same else "DIFFER"
        print(f"{key} {tuple(x.shape)}: {verdict}; {int(ne.sum())} of "
              f"{x.numel()} elements differ, max |a-b| "
              f"{d.max().item() if d.numel() else 0.0:.3e}")
    print(f"{equal} of {len(ta)} outputs bitwise equal")


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
