#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):
  1. device: a CUDA card, its name and power limit, TF32 off;
  2. build: nvcc compiles the kernels from csrc/ (one process per source,
     in parallel; timed);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the ViT-B/16 main-path shapes and at a ragged small shape: the
     exact-FP32 kernels in float64 (rtol 1e-9, atol 1e-12) and float32, the
     block megakernels (float32 only) in each preset's product modes, all
     float32 results by the rule below against the float64 plain version;
  4. slices, each driven with the launch counts set to 0 just before and
     read just after: ``Explainer(params, VIT_BASE_16_224, device="cuda")``
     (exact FP32) and ``Explainer(..., **precision_kwargs("production"))``
     explain three batches of 8 images (random weights from a seeded
     generator); output shape, finiteness, bitwise repeatability, launch
     counts per batch, and the per-sample Pearson correlation against the
     port's plain path of the same preset in float64 on the same card
     (exact FP32: >= 0.999 every sample; production: median >= 0.999 and
     min no lower than the plain float32 production path's min - 0.01);
     the production path's corr against the exact float64 path is printed;
  5. times: each kernel beside its plain version, and explanations/s at B=8
     for the exact-FP32 and the production paths, kernels and plain.

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
PROD_MIN_SLACK = 0.01
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
        explain_batch, precision_kwargs)
    from transformer_explainability_torch.models.vit import (
        VIT_BASE_16_224, VisionTransformer, init_params)
    from transformer_explainability_torch.explain import Explainer
    from transformer_explainability_torch.ops import _build
    from transformer_explainability_torch.ops import block_math as bm
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops import precision as prec
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
        # one line per kernel: registers and spills (-Xptxas -v)
        entry, spill = None, ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                regs = line.split("Used")[1].split(",")[0].strip()
                print(f"  ptxas {entry[:72]}: {regs}; {spill}")
                entry = None

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

    def f32_rule(name, k32, p32, p64):
        """float32 kernel vs plain float32, both against plain float64."""
        require(torch.isfinite(k32).all().item(),
                f"{name}: non-finite float32 output")
        ek = (k32.double() - p64).abs().max().item()
        ep = (p32.double() - p64).abs().max().item()
        lim = F32_FACTOR * ep + F32_FLOOR * p64.abs().max().item()
        e32 = (k32 - p32).abs().max().item()
        print(f"check {name}: f32 max|k-p|={e32:.3e}, max|k32-p64|={ek:.3e}"
              f" <= {lim:.3e} (plain f32 {ep:.3e})")
        require(ek <= lim, f"{name}: float32 kernel error {ek:.3e} above "
                f"{lim:.3e}")
        return e32

    # block megakernels, in the product modes (mxu, attn_mxu, rule_mxu,
    # mlp_mxu) of the two presets
    block_modes = {"production": ("tensorfloat32", "float32", "bfloat16",
                                  "bfloat16"),
                   "bfloat16": ("bfloat16", "bfloat16", "bfloat16", None)}

    def block_case(b, nn_, hh, dd, base):
        D, M = hh * dd, 4 * hh * dd

        def w(o, i):
            return randn(o, i, dtype=torch.float64) / i ** 0.5

        def vec(k, centre=0.0):
            return centre + 0.1 * randn(k, dtype=torch.float64)

        ws = [prec.prepare_weight(t, base)
              for t in (w(3 * D, D), w(D, D), w(M, D), w(D, M))]
        vecs = [vec(D, 1.0), vec(D), vec(D, 1.0), vec(D), vec(3 * D),
                vec(D), vec(M), vec(D)]
        p64 = bm.BlockParams(*vecs, *ws)
        p32 = bm.BlockParams(*[v.float() for v in vecs], *ws)
        x = randn(b, nn_, D, dtype=torch.float64, offset=0.5)
        g_out, R = (randn(b, nn_, D, dtype=torch.float64) for _ in range(2))
        return p64, p32, x, g_out, R

    fwd_names = ["x_out", "x_mid", "out_m", "qkv_pre", "proj_pre", "dots",
                 "probs", "fc1_pre", "fc2_pre"]
    block_inputs = {}
    for preset, (mxu, attn, rule, mlp) in block_modes.items():
        for sname, (b, nn_, hh, dd) in shapes.items():
            p64, p32, x, g_out, R = block_case(b, nn_, hh, dd, mxu)
            fargs = (hh, dd, cfg.block_ln_eps, mxu, attn, mlp, True, True)
            before = K.block_fwd_core.launches
            k32 = K.block_fwd_core(x.float(), p32, *fargs)
            torch.cuda.synchronize()
            require(K.block_fwd_core.launches == before + 1,
                    "block_fwd_core: launch count did not rise")
            f64 = bm.block_fwd_core_plain(x, p64, *fargs)
            f32 = bm.block_fwd_core_plain(x.float(), p32, *fargs)
            for i, nm in enumerate(fwd_names):
                e = f32_rule(f"block_fwd_core[{nm}] {preset} {sname} "
                             f"{(b, nn_, hh, dd)}", k32[i], f32[i], f64[i])
                if sname == "main":
                    errs["block_fwd_core"] = max(
                        errs.get("block_fwd_core", 0.0), e)
            # the reverse from the float64 forward's own anchors
            a64 = (x, f64[1], f64[2], g_out, R)
            a32 = tuple(t.float() for t in a64)
            s64, s32 = f64[3:], tuple(t.float() for t in f64[3:])
            rargs = (hh, dd, cfg.block_ln_eps, mxu, attn, rule, mlp)
            before = K.block_rev_core.launches
            k32 = K.block_rev_core(*a32, p32, *rargs, saved=s32)
            torch.cuda.synchronize()
            require(K.block_rev_core.launches == before + 1,
                    "block_rev_core: launch count did not rise")
            r64 = bm.block_rev_core_plain(*a64, p64, *rargs, saved=s64)
            r32 = bm.block_rev_core_plain(*a32, p32, *rargs, saved=s32)
            for i, nm in enumerate(["g_in", "R_in", "gc"]):
                e = f32_rule(f"block_rev_core[{nm}] {preset} {sname} "
                             f"{(b, nn_, hh, dd)}", k32[i], r32[i], r64[i])
                if sname == "main":
                    errs["block_rev_core"] = max(
                        errs.get("block_rev_core", 0.0), e)
            if preset == "production" and sname == "main":
                block_inputs = dict(p32=p32, x=x.float(), a32=a32, s32=s32,
                                    fargs=fargs, rargs=rargs)
            del p64, p32, x, g_out, R, k32, f64, f32, r64, r32
    torch.cuda.empty_cache()

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

    def drive(explainer, per_batch, label):
        """Explain the three batches twice each (counts set to 0 before,
        read after); returns the heatmaps and the counts."""
        K.reset_launch_counts()
        heats = []
        for k, (imgs, idx) in enumerate(batches):
            c0 = K.launch_counts()
            heat = explainer.explain(imgs, idx)
            torch.cuda.synchronize()
            c1 = K.launch_counts()
            rose = {w: c1[w] - c0[w] for w in c1}
            require(rose == per_batch,
                    f"{label} batch {k}: launch counts rose by {rose}")
            require(tuple(heat.shape) == (8, cfg.num_patches),
                    f"{label} batch {k}: shape {tuple(heat.shape)}")
            require(torch.isfinite(heat).all().item(),
                    f"{label} batch {k}: non-finite")
            again = explainer.explain(imgs, idx)
            require(torch.equal(heat, again),
                    f"{label} batch {k}: not bitwise repeatable")
            heats.append(heat)
        counts = K.launch_counts()
        print(f"{label} slice launches: {counts}")
        return heats, counts

    none = {w: 0 for w in K.launch_counts()}
    heats, launches = drive(ex, {**none, "attn_fwd_core": L,
                                 "attn_rev_core": L,
                                 "rollout_from_grad_cam": 1}, "float32")
    prod = precision_kwargs("production")
    ex_prod = Explainer(params, cfg, device="cuda", **prod)
    heats_prod, launches_prod = drive(
        ex_prod, {**none, "block_fwd_core": L, "block_rev_core": L,
                  "rollout_from_grad_cam": 1}, "production")

    def corr(x, y):
        a = x.double() - x.double().mean(dim=1, keepdim=True)
        b = y - y.mean(dim=1, keepdim=True)
        return ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).tolist()

    corrs, plain_corrs = [], []
    p_corrs, p_plain_corrs, p_exact = [], [], []
    for (imgs, idx), heat, heat_p in zip(batches, heats, heats_prod):
        idx_t = torch.as_tensor(idx, device=dev)
        img64 = torch.as_tensor(imgs, device=dev, dtype=torch.float64)
        img32 = torch.as_tensor(imgs, device=dev)
        ref = explain_batch(model64, img64, idx_t, ops=K.PLAIN_OPS)
        plain32 = explain_batch(ex.model, img32, idx_t, ops=K.PLAIN_OPS)
        corrs += corr(heat, ref)
        plain_corrs += corr(plain32, ref)
        ref_p = explain_batch(model64, img64, idx_t, ops=K.PLAIN_OPS, **prod)
        plain32_p = explain_batch(ex_prod.model, img32, idx_t,
                                  ops=K.PLAIN_OPS, **prod)
        p_corrs += corr(heat_p, ref_p)
        p_plain_corrs += corr(plain32_p, ref_p)
        p_exact += corr(heat_p, ref)
    corrs, plain_corrs = np.asarray(corrs), np.asarray(plain_corrs)
    p_corrs, p_plain_corrs = np.asarray(p_corrs), np.asarray(p_plain_corrs)
    p_exact = np.asarray(p_exact)
    print(f"slice corr vs plain f64 on the card: min {corrs.min():.6f} "
          f"median {np.median(corrs):.6f} over {len(corrs)} samples "
          f"(plain f32 path: min {plain_corrs.min():.6f} median "
          f"{np.median(plain_corrs):.6f}); per sample "
          f"{np.array2string(corrs, precision=6, max_line_width=1000)}")
    require(corrs.min() >= MIN_CORR, f"per-sample corr {corrs.min():.6f} "
            f"below {MIN_CORR}")
    print(f"production slice corr vs plain production f64 on the card: min "
          f"{p_corrs.min():.6f} median {np.median(p_corrs):.6f} (plain f32 "
          f"production path: min {p_plain_corrs.min():.6f} median "
          f"{np.median(p_plain_corrs):.6f}); per sample "
          f"{np.array2string(p_corrs, precision=6, max_line_width=1000)}")
    print(f"production slice corr vs exact f64 (float32 preset, plain) on "
          f"the card, not gated: min {p_exact.min():.6f} median "
          f"{np.median(p_exact):.6f} mean {p_exact.mean():.6f}; per sample "
          f"{np.array2string(p_exact, precision=6, max_line_width=1000)}")
    require(np.median(p_corrs) >= MIN_CORR,
            f"production median corr {np.median(p_corrs):.6f} below "
            f"{MIN_CORR}")
    require(p_corrs.min() >= p_plain_corrs.min() - PROD_MIN_SLACK,
            f"production min corr {p_corrs.min():.6f} below the plain f32 "
            f"path's {p_plain_corrs.min():.6f} - {PROD_MIN_SLACK}")

    # 5. times ---------------------------------------------------------------
    times = {}
    for name, (make, kern, plain) in cases.items():
        args = make(*shapes["main"], torch.float32)
        times[name] = (time_ms(lambda: kern(*args)),
                       time_ms(lambda: plain(*args)))
        print(f"time {name} {tuple(shapes['main'])} f32: kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms {tag}")

    bi = block_inputs
    times["block_fwd_core"] = (
        time_ms(lambda: K.block_fwd_core(bi["x"], bi["p32"], *bi["fargs"])),
        time_ms(lambda: bm.block_fwd_core_plain(bi["x"], bi["p32"],
                                                *bi["fargs"])))
    times["block_rev_core"] = (
        time_ms(lambda: K.block_rev_core(*bi["a32"], bi["p32"], *bi["rargs"],
                                         saved=bi["s32"])),
        time_ms(lambda: bm.block_rev_core_plain(*bi["a32"], bi["p32"],
                                                *bi["rargs"],
                                                saved=bi["s32"])))
    for name in ("block_fwd_core", "block_rev_core"):
        print(f"time {name} {tuple(shapes['main'])} f32 production modes: "
              f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} "
              f"ms {tag}")
    del block_inputs, bi

    imgs_t = torch.as_tensor(batches[0][0], device=dev)
    idx_t = torch.as_tensor(batches[0][1], device=dev)

    def rate(ops, nb=20, **kw):
        for _ in range(3):
            explain_batch(ex.model, imgs_t, idx_t, ops=ops, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(nb):
            explain_batch(ex.model, imgs_t, idx_t, ops=ops, **kw)
        torch.cuda.synchronize()
        return nb * 8 / (time.perf_counter() - t)

    def peak_gib(ops, **kw):
        """Device memory one batch needs above what is resident (models,
        prepared weights, references)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        explain_batch(ex.model, imgs_t, idx_t, ops=ops, **kw)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    peak = peak_gib(K.KERNEL_OPS)
    r_kernel = rate(K.KERNEL_OPS)
    r_plain = rate(K.PLAIN_OPS)
    r_kernel2 = rate(K.KERNEL_OPS)
    print(f"e2e transformer_attribution ViT-B/16 f32 B=8, 20-batch windows: "
          f"kernel path {r_kernel:.2f} / {r_kernel2:.2f} expl/s, plain path "
          f"{r_plain:.2f} expl/s, batch working memory {peak:.3f} GiB {tag}")
    peak_p = peak_gib(K.KERNEL_OPS, **prod)
    rp_kernel = rate(K.KERNEL_OPS, **prod)
    rp_plain = rate(K.PLAIN_OPS, **prod)
    rp_kernel2 = rate(K.KERNEL_OPS, **prod)
    print(f"e2e transformer_attribution ViT-B/16 production B=8, 20-batch "
          f"windows: kernel path {rp_kernel:.2f} / {rp_kernel2:.2f} expl/s, "
          f"plain path {rp_plain:.2f} expl/s, batch working memory "
          f"{peak_p:.3f} GiB {tag}")

    sources = {"attn_fwd_core": "attn_fwd.cu", "attn_rev_core": "attn_rev.cu",
               "rollout_from_grad_cam": "rollout.cu",
               "block_fwd_core": "block_fwd.cu",
               "block_rev_core": "block_rev.cu"}
    tpu_lines = {"attn_fwd_core": 391, "attn_rev_core": 415,
                 "rollout_from_grad_cam": 49, "block_fwd_core": 1378,
                 "block_rev_core": 1223}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"transformer_explainability_torch/csrc/{sources[name]}",
         "replaces": f"{TPU_KERNELS}:{tpu_lines[name]}",
         "launches": launches[name] + launches_prod[name],
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in sources]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
