#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):
  1. device: a CUDA card, its name and power limit, TF32 off;
  2. build: nvcc compiles the kernels from csrc/ (timed);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the ViT-B/16 main-path shapes and at a ragged small shape, in float64
     (rtol 1e-9, atol 1e-12) and float32 (tolerance below);
  4. slice: ``Explainer(params, VIT_BASE_16_224, device="cuda")`` explains
     three batches of 8 images (random weights from a seeded generator);
     output shape, finiteness, bitwise repeatability, launch counts, and the
     per-sample Pearson correlation against the port's plain path in float64
     on the same card (>= 0.999);
  5. times: each kernel beside its plain version, and explanations/s at B=8.

It imports no JAX. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it the card's name and power limit, and the one before that
a JSON object with one entry per kernel.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# float32 gate. A direct float32-vs-float32 comparison is ill-posed here: the
# safe-divide z-rules turn 1-ulp differences of near-zero denominators into
# large relative ones. So each float32 output must be as close to the float64
# plain result as PyTorch's own float32 path is, within F32_FACTOR (room for
# another summation order), plus F32_FLOOR of the output's magnitude.
F32_FACTOR = 10.0
F32_FLOOR = 1e-6
F64_RTOL, F64_ATOL = 1e-9, 1e-12
MIN_CORR = 0.999
TPU_KERNELS = "transformer_explainability_tpu/ops/pallas_kernels.py"


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, from CUDA events around ``iters`` calls
    after ``warmup`` (inputs stay in L2 between calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    pkg_dir = os.path.join(ROOT, "transformer_explainability_torch")
    if not os.path.isdir(pkg_dir):
        print(f"chip_smoke: the port package is not beside this script "
              f"({pkg_dir})", file=sys.stderr)
        return 2
    from transformer_explainability_torch.explain.generator import (
        explain_batch)
    from transformer_explainability_torch.models.vit import (
        VIT_BASE_16_224, VisionTransformer, init_params)
    from transformer_explainability_torch.explain import Explainer
    from transformer_explainability_torch.ops import _build
    from transformer_explainability_torch.ops import kernels as K
    import transformer_explainability_torch as te
    require(os.path.dirname(os.path.dirname(os.path.abspath(te.__file__)))
            == ROOT, f"imported the port from {te.__file__}, not from {ROOT}")

    # 1. device ------------------------------------------------------------
    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    require(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    dev = torch.device("cuda")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s"
          f" (0 if cached)")
    log = so.parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())

    # 3. kernels against their plain versions --------------------------------
    cfg = VIT_BASE_16_224
    B, n, h, hd, L = 8, cfg.num_tokens, cfg.num_heads, cfg.head_dim, cfg.depth
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype, offset=0.0):
        return (torch.randn(*shape, generator=gen, device=dev,
                            dtype=torch.float64) + offset).to(dtype)

    def attn_inputs(b, nn_, hh, dd, dtype):
        # q, k, v offset from 0 so that the z-rule denominators (q·k and
        # attn·v) stay away from 0, where the comparison would measure
        # the conditioning of the division instead of the kernel
        return (randn(b, nn_, 3 * hh * dd, dtype=dtype, offset=1.0),
                randn(b, nn_, hh * dd, dtype=dtype),
                randn(b, nn_, hh * dd, dtype=dtype))

    def rollout_inputs(b, ll, nn_, dtype):
        # non-negative, small, like the head-mean (grad ⊙ cam)⁺ maps
        return (randn(b, ll, nn_, nn_, dtype=dtype).abs() * 1e-3)

    cases = {
        "attn_fwd_core": (
            lambda b, nn_, hh, dd, dt: (attn_inputs(b, nn_, hh, dd, dt)[0],
                                        hh, dd, dd ** -0.5),
            K.attn_fwd_core, K.attn_fwd_core_plain),
        "attn_rev_core": (
            lambda b, nn_, hh, dd, dt: (*attn_inputs(b, nn_, hh, dd, dt),
                                        hh, dd, dd ** -0.5),
            K.attn_rev_core, K.attn_rev_core_plain),
        "rollout_from_grad_cam": (
            lambda b, nn_, hh, dd, dt: (rollout_inputs(b, L, nn_, dt), 0),
            K.rollout_from_grad_cam, K.rollout_plain),
    }
    shapes = {"main": (B, n, h, hd), "ragged": (2, 29, 3, 8)}
    errs = {}
    for name, (make, kern, plain) in cases.items():
        for sname, shp in shapes.items():
            args64 = make(*shp, torch.float64)
            args32 = tuple(a.float() if torch.is_tensor(a) else a
                           for a in args64)
            before = kern.launches
            k64, k32 = kern(*args64), kern(*args32)
            torch.cuda.synchronize()
            require(kern.launches == before + 2,
                    f"{name}: launch count did not rise")
            p64, p32 = plain(*args64), plain(*args32)
            outs = lambda x: x if isinstance(x, tuple) else (x,)
            for i, (a64, a32, b64, b32) in enumerate(zip(
                    outs(k64), outs(k32), outs(p64), outs(p32))):
                require(torch.isfinite(a32).all().item(),
                        f"{name}[{i}] {sname}: non-finite float32 output")
                e64 = (a64 - b64).abs().max().item()
                require(torch.allclose(a64, b64, rtol=F64_RTOL,
                                       atol=F64_ATOL),
                        f"{name}[{i}] {sname}: float64 kernel differs from "
                        f"plain by {e64:.3e}")
                ek = (a32.double() - b64).abs().max().item()
                ep = (b32.double() - b64).abs().max().item()
                lim = F32_FACTOR * ep + F32_FLOOR * b64.abs().max().item()
                e32 = (a32 - b32).abs().max().item()
                print(f"check {name}[{i}] {sname} {tuple(shp)}: f64 "
                      f"max|k-p|={e64:.3e}; f32 max|k-p|={e32:.3e}, "
                      f"max|k32-p64|={ek:.3e} <= {lim:.3e} "
                      f"(plain f32 {ep:.3e})")
                require(ek <= lim, f"{name}[{i}] {sname}: float32 kernel "
                        f"error {ek:.3e} above {lim:.3e}")
                if sname == "main":
                    errs[name] = max(errs.get(name, 0.0), e32)

    # 4. the slice ----------------------------------------------------------
    data = np.load(os.path.join(ROOT, "experiments/data/fidelity_truth.npz"))
    imgs_all, idx_all = data["imgs"], data["idx"].astype(np.int64)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    ex = Explainer(params, cfg, device="cuda")
    model64 = VisionTransformer(cfg, device=dev, dtype=torch.float64)
    model64.load_state_dict({k: v.double() for k, v in params.items()})
    model64.requires_grad_(False)
    batches = []
    for k in range(3):
        rows = (8 * k + np.arange(8)) % len(imgs_all)
        idx = idx_all[rows].copy()
        idx[[1, 5]] = -1                  # argmax class
        batches.append((imgs_all[rows], idx))

    K.reset_launch_counts()
    heats = []
    for k, (imgs, idx) in enumerate(batches):
        c0 = K.launch_counts()
        heat = ex.explain(imgs, idx)
        torch.cuda.synchronize()
        c1 = K.launch_counts()
        rose = {w: c1[w] - c0[w] for w in c1}
        require(rose == {"attn_fwd_core": L, "attn_rev_core": L,
                         "rollout_from_grad_cam": 1},
                f"batch {k}: launch counts rose by {rose}")
        require(tuple(heat.shape) == (8, cfg.num_patches),
                f"batch {k}: shape {tuple(heat.shape)}")
        require(torch.isfinite(heat).all().item(), f"batch {k}: non-finite")
        again = ex.explain(imgs, idx)
        require(torch.equal(heat, again), f"batch {k}: not bitwise repeatable")
        heats.append(heat)
    launches = K.launch_counts()
    print(f"slice launches: {launches}")

    def corr(x, y):
        a = x.double() - x.double().mean(dim=1, keepdim=True)
        b = y - y.mean(dim=1, keepdim=True)
        return ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).tolist()

    corrs, plain_corrs = [], []
    for (imgs, idx), heat in zip(batches, heats):
        idx_t = torch.as_tensor(idx, device=dev)
        ref = explain_batch(
            model64, torch.as_tensor(imgs, device=dev, dtype=torch.float64),
            idx_t, ops=K.PLAIN_OPS)
        plain32 = explain_batch(ex.model, torch.as_tensor(imgs, device=dev),
                                idx_t, ops=K.PLAIN_OPS)
        corrs += corr(heat, ref)
        plain_corrs += corr(plain32, ref)
    corrs, plain_corrs = np.asarray(corrs), np.asarray(plain_corrs)
    print(f"slice corr vs plain f64 on the card: min {corrs.min():.6f} "
          f"median {np.median(corrs):.6f} over {len(corrs)} samples "
          f"(plain f32 path: min {plain_corrs.min():.6f} median "
          f"{np.median(plain_corrs):.6f}); per sample "
          f"{np.array2string(corrs, precision=6, max_line_width=1000)}")
    require(corrs.min() >= MIN_CORR, f"per-sample corr {corrs.min():.6f} "
            f"below {MIN_CORR}")

    # 5. times ---------------------------------------------------------------
    times = {}
    for name, (make, kern, plain) in cases.items():
        args = make(*shapes["main"], torch.float32)
        times[name] = (time_ms(lambda: kern(*args)),
                       time_ms(lambda: plain(*args)))
        print(f"time {name} {tuple(shapes['main'])} f32: kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms {tag}")

    imgs_t = torch.as_tensor(batches[0][0], device=dev)
    idx_t = torch.as_tensor(batches[0][1], device=dev)
    torch.cuda.reset_peak_memory_stats()

    def rate(ops, nb=20):
        for _ in range(3):
            explain_batch(ex.model, imgs_t, idx_t, ops=ops)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(nb):
            explain_batch(ex.model, imgs_t, idx_t, ops=ops)
        torch.cuda.synchronize()
        return nb * 8 / (time.perf_counter() - t)

    r_kernel = rate(K.KERNEL_OPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    r_plain = rate(K.PLAIN_OPS)
    r_kernel2 = rate(K.KERNEL_OPS)
    print(f"e2e transformer_attribution ViT-B/16 f32 B=8, 20-batch windows: "
          f"kernel path {r_kernel:.2f} / {r_kernel2:.2f} expl/s, plain path "
          f"{r_plain:.2f} expl/s, peak {peak:.2f} GiB {tag}")

    sources = {"attn_fwd_core": "attn_fwd.cu", "attn_rev_core": "attn_rev.cu",
               "rollout_from_grad_cam": "rollout.cu"}
    tpu_lines = {"attn_fwd_core": 391, "attn_rev_core": 415,
                 "rollout_from_grad_cam": 49}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"transformer_explainability_torch/csrc/{sources[name]}",
         "replaces": f"{TPU_KERNELS}:{tpu_lines[name]}",
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in cases]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
