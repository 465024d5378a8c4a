"""Where the device time goes in the PyTorch port's ViT-B/16
``transformer_attribution`` (B=8), on one CUDA card.

    python3 experiments/torch_profile_vit.py [--precision float32|production|bfloat16]
                                             [--batches 4] [--out DIR]

``--precision`` names a preset of ``PRECISION_PRESETS`` (default float32:
exact FP32; production and bfloat16 run the block megakernels).

Runs the kernel path (and, for comparison, the plain path) under
``torch.profiler`` after a warm-up, and prints: the wall time per batch, the
device busy share (sum of kernel times over the wall time of the window;
one stream, so kernels do not overlap), and the device time by group
(cuBLAS/CUTLASS GEMMs, the port's own kernels, other PyTorch kernels) and by
kernel name. Writes a Chrome trace per path under ``--out`` (default
``build/profiles``, git-ignored). Random weights
from a seeded generator; needs no JAX.
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def group(name: str) -> str:
    low = name.lower()
    if "te::gemm_kernel" in name:
        return "port GEMM core (tensor cores)"
    if "te::" in name or name.startswith(("attn_", "rollout_", "head_mean",
                                           "blk_", "gemm_", "ln_", "add_")):
        return "port kernels"
    if "gemm" in low or "cutlass" in low or "sm90_xmma" in low:
        return "GEMM (cuBLAS)"
    return "other PyTorch kernels"


def profile(fn, batches: int, trace: str):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    by_name, by_group = defaultdict(float), defaultdict(float)
    for evt in prof.key_averages():
        # kernel events only: the CPU-side aten ops also carry the device
        # time of the kernels they launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dt = evt.self_device_time_total
        by_name[evt.key] += dt
        by_group[group(evt.key)] += dt
    return wall, by_name, by_group


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "production", "bfloat16"])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from transformer_explainability_torch.explain.generator import (
        explain_batch, precision_kwargs)
    from transformer_explainability_torch.models.vit import (
        VIT_BASE_16_224 as cfg, VisionTransformer, init_params)
    from transformer_explainability_torch.ops import kernels as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    model = VisionTransformer(cfg, device=dev)
    model.load_state_dict(params)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.randn(8, 3, 224, 224, generator=gen, device=dev)
    idx = torch.full((8,), -1, dtype=torch.int64, device=dev)
    os.makedirs(args.out, exist_ok=True)
    prec = precision_kwargs(args.precision)
    for label, ops in (("kernel", K.KERNEL_OPS), ("plain", K.PLAIN_OPS)):
        wall, by_name, by_group = profile(
            lambda: explain_batch(model, imgs, idx, ops=ops, **prec),
            args.batches, os.path.join(
                args.out, f"trace_vit_{args.precision}_{label}.json"))
        busy = sum(by_name.values()) / 1e6
        per = wall / args.batches
        print(f"[{card}] {args.precision} {label} path: {per * 1e3:.2f} "
              f"ms/batch of 8 under "
              f"the profiler, device busy {busy / wall:.1%}")
        for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {g:24s} {us / 1e3 / args.batches:9.3f} ms/batch "
                  f"({us / 1e6 / busy:.1%} of device time)")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
            print(f"    {us / 1e3 / args.batches:9.3f} ms  {name[:100]}")


if __name__ == "__main__":
    main()
