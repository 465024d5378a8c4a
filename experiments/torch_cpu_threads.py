"""The host CPU that ``chip_smoke.py``'s CPU-side draws run on: how many
cores the process may use, how many threads PyTorch takes, and how fast a
ViT-B/16-width float32 and float64 product runs on the CPU at a few thread
counts.

    python3 experiments/torch_cpu_threads.py

Prints ``os.cpu_count()``, the scheduler affinity, the cgroup CPU quota
(``/sys/fs/cgroup/cpu.max``, read only), ``torch.get_num_threads()``, and,
per thread count, the ms of a (788, 768) x (768, 2304) product (the qkv
product of 4 ViT-B/16 samples) in float32 and float64, best of 20 after
warm-up. Needs no card and no JAX.
"""

import os
import time

import torch


def quota() -> str:
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable ({e.__class__.__name__})"


def best_ms(a, b, n=20) -> float:
    for _ in range(3):
        a @ b
    best = float("inf")
    for _ in range(n):
        t = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def main() -> None:
    aff = len(os.sched_getaffinity(0))
    default = torch.get_num_threads()
    print(f"os.cpu_count() {os.cpu_count()}, affinity {aff}, cgroup cpu.max "
          f"{quota()}, torch threads {default}, interop "
          f"{torch.get_num_interop_threads()}")
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        a = torch.randn(788, 768, generator=g, dtype=dtype)
        b = torch.randn(768, 2304, generator=g, dtype=dtype)
        flops = 2 * 788 * 768 * 2304
        for n in sorted({default, aff, max(1, aff // 2), 1}):
            torch.set_num_threads(n)
            ms = best_ms(a, b)
            print(f"{dtype}: {n} threads {ms:.3f} ms, "
                  f"{flops / ms / 1e6:.1f} GFLOP/s")
        torch.set_num_threads(default)


if __name__ == "__main__":
    main()
