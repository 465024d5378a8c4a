"""The GEMM core alone (``ops.kernels.gemm_core``) in both of its tiles at
the main paths' product shapes, on one CUDA card.

    python3 experiments/torch_gemm_tiles.py

For each (M, N, K) of ViT-B/16 B=8 (M = 1576) and BERT-base B=8 S=512
(M = 4096) with N, K in {768, 3072}, each instance the layer kernels
launch (x·Wᵀ, g·W, |x|·|W|ᵀ, the dual S·W / S·|W|) and both product
modes, prints the device time of one launch (profiler) in the large tile
(128 rows), in the small one (64 rows) and in the tile the layer kernels
take (``gemm_small_tile``), with the TFLOP/s of bf16 passes. The small
tile's cost per output element relative to the large one's, where both
fill the card, is what ``gemm_small_tile`` weighs. Needs no JAX.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_ms(fn, iters=20):
    """Device time of one call (profiler); a window in which the profiler
    saw no device time is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / iters / 1e3
    raise RuntimeError("the profiler saw no device time")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops import precision as P
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    instances = {"x.Wt": (True, False, False), "g.W": (False, False, False),
                 "|x|.|W|t": (True, True, False),
                 "S.W dual": (False, False, True)}
    for M in (1576, 4096):
        for N, Kd in ((3072, 768), (768, 3072)):
            a = torch.randn(M, Kd, generator=gen, device="cuda")
            for mode in ("bfloat16", "tensorfloat32"):
                for name, (wt, ab, du) in instances.items():
                    shape = (N, Kd) if wt else (Kd, N)
                    w = P.prepare_weight(torch.randn(
                        *shape, generator=gen, device="cuda") / Kd ** 0.5,
                        mode)
                    passes = (3 if mode == "tensorfloat32" else 1) * (
                        2 if du else 1)
                    ms = [device_ms(lambda: K.gemm_core(a, w, mode, wt, ab,
                                                        du, tile=t))
                          for t in (0, 1, -1)]
                    tf = [2.0 * M * N * Kd * passes / t / 1e9 for t in ms]
                    print(f"({M}, {N}, {Kd}) {name} {mode}: large "
                          f"{ms[0]:.4f} ms ({tf[0]:.0f} TFLOP/s), small "
                          f"{ms[1]:.4f} ms ({tf[1]:.0f}), the layer "
                          f"kernels' tile {ms[2]:.4f} ms [{card}]")


if __name__ == "__main__":
    main()
