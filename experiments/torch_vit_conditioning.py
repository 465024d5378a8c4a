"""How well-conditioned a ViT configuration's exact explanation is, on one
CUDA card.

    python3 experiments/torch_vit_conditioning.py [--model vit_large|vit|deit_distilled]
                                                  [--precision float32|production]

The model with ``chip_smoke.py``'s seeded random weights (``init_params``,
seed 0) and its three batches of 8 images from
``experiments/data/fidelity_truth.npz`` (the same rows and argmax indices).
For ``transformer_attribution`` in the preset, per sample, the Pearson corr
against the float64 plain path of the same preset of:

  * the float32 kernel path (what ``chip_smoke.py`` phase 4 gates);
  * the float32 plain path (the kernels' plain versions, cuBLAS, TF32 off);
  * the float32 plain path with every weight moved to a float32 neighbour,
    up or down at random (seeded): another float32 draw of the function;
  * the float64 plain path with every weight moved by about one float32
    ulp (each element times 1 + 2⁻²⁴·u, u uniform in [−1, 1], seeded).

If the last is as far from 1 as the float32 paths on a sample, the map
there changes with ulp-sized changes of the weights; if the float32 draws
spread there while it does not, float32 rounding inside the computation
moves it. Either way a float32 implementation cannot be expected to reach
it. ``--swap`` adds the float32 kernel path with each kernel of the path in
turn replaced by its plain version, to find which kernel moves a sample.
``--draws N`` adds N more float32 draws of both the kernel and the plain
path (the weights moved one float32 ulp with seeds 1 … N) and prints each
sample's lowest and highest corr over the draws of each, to tell a kernel
that is less accurate on a sample from one whose rounding happened to land
differently. Needs no JAX.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def batches():
    """``chip_smoke.py``'s three ViT batches: images and indices."""
    data = np.load(os.path.join(ROOT, "experiments/data/fidelity_truth.npz"))
    imgs, idx = data["imgs"], data["idx"].astype(np.int64)
    out = []
    for k in range(3):
        rows = (8 * k + np.arange(8)) % len(imgs)
        i = idx[rows].copy()
        i[[1, 5]] = -1
        out.append((imgs[rows], i))
    return out


def corr(x, y):
    a = x.double() - x.double().mean(dim=1, keepdim=True)
    b = y.double() - y.double().mean(dim=1, keepdim=True)
    return ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).cpu().numpy()


def main():
    from transformer_explainability_torch.explain.generator import (
        explain_batch, precision_kwargs)
    from transformer_explainability_torch.models import vit
    from transformer_explainability_torch.ops import kernels as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vit_large",
                    choices=["vit", "vit_large", "deit_distilled"])
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "production"])
    ap.add_argument("--swap", action="store_true")
    ap.add_argument("--draws", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = {"vit": vit.VIT_BASE_16_224, "vit_large": vit.VIT_LARGE_16_224,
           "deit_distilled": vit.DEIT_BASE_DISTILLED_16_224}[args.model]
    params = vit.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)

    def model_of(sd, dtype):
        model = vit.VisionTransformer(cfg, device=dev, dtype=dtype)
        model.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
        return model.requires_grad_(False)

    def moved(v):
        u = torch.rand(v.shape, generator=gen, device=dev,
                       dtype=torch.float64) * 2 - 1
        return v.double() * (1 + 2.0 ** -24 * u)

    def moved32(v, g=gen):
        inf = torch.tensor(float("inf"), device=dev)
        up = torch.rand(v.shape, generator=g, device=dev) < 0.5
        return torch.where(up, torch.nextafter(v, inf),
                           torch.nextafter(v, -inf))

    m32 = model_of(params, torch.float32)
    m64 = model_of(params, torch.float64)
    m64u = model_of({k: moved(v) for k, v in params.items()}, torch.float64)
    m32u = model_of({k: moved32(v) for k, v in params.items()},
                    torch.float32)
    kw = precision_kwargs(args.precision)
    swaps = {}
    if args.swap:
        names = (("attn_fwd_core", "attn_rev_core") if args.precision ==
                 "float32" else ("block_fwd_core", "block_rev_core"))
        swaps = {name: K.KERNEL_OPS._replace(**{name: getattr(K.PLAIN_OPS,
                                                              name)})
                 for name in names + ("rollout_from_grad_cam",)}
    cs = {name: [] for name in swaps}
    ck, cp, cpu, cu = [], [], [], []
    for imgs, idx in batches():
        idx_t = torch.as_tensor(idx, device=dev)
        x64 = torch.as_tensor(imgs, device=dev, dtype=torch.float64)
        ref = explain_batch(m64, x64, idx_t, ops=K.PLAIN_OPS, **kw)
        ck.append(corr(explain_batch(m32, x64.float(), idx_t, **kw), ref))
        cp.append(corr(explain_batch(m32, x64.float(), idx_t,
                                     ops=K.PLAIN_OPS, **kw), ref))
        cpu.append(corr(explain_batch(m32u, x64.float(), idx_t,
                                      ops=K.PLAIN_OPS, **kw), ref))
        cu.append(corr(explain_batch(m64u, x64, idx_t, ops=K.PLAIN_OPS,
                                     **kw), ref))
        for name, ops in swaps.items():
            cs[name].append(corr(explain_batch(m32, x64.float(), idx_t,
                                               ops=ops, **kw), ref))
    fmt = lambda a: np.array2string(np.concatenate(a), precision=6,
                                    max_line_width=1000)
    print(f"[{card}] {args.model} {args.precision} transformer_attribution "
          f"corr vs float64 per sample:\n  float32 kernel path {fmt(ck)}\n"
          f"  float32 plain path  {fmt(cp)}\n  float32 plain path, weights "
          f"moved one float32 ulp {fmt(cpu)}\n  float64 with weights moved "
          f"~1 float32 ulp {fmt(cu)}")
    for name, c in cs.items():
        print(f"  float32 kernel path, {name} plain {fmt(c)}")
    draws = {"kernel": [], "plain": []}
    for seed in range(1, args.draws + 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        md = model_of({k: moved32(v, g) for k, v in params.items()},
                      torch.float32)
        for label, ops in (("kernel", K.KERNEL_OPS), ("plain", K.PLAIN_OPS)):
            c = []
            for imgs, idx in batches():
                idx_t = torch.as_tensor(idx, device=dev)
                x64 = torch.as_tensor(imgs, device=dev, dtype=torch.float64)
                ref = explain_batch(m64, x64, idx_t, ops=K.PLAIN_OPS, **kw)
                c.append(corr(explain_batch(md, x64.float(), idx_t, ops=ops,
                                            **kw), ref))
            draws[label].append(np.concatenate(c))
        del md
    for label, d in draws.items():
        if d:
            d = np.stack(d)
            print(f"  float32 {label} path over {len(d)} draws of weights "
                  f"moved one float32 ulp: lowest {fmt([d.min(0)])}\n"
                  f"    highest {fmt([d.max(0)])}")


if __name__ == "__main__":
    main()
