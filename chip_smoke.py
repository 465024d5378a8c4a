#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):
  1. device: a CUDA card, its name and power limit, TF32 off, and which of
     PIL, h5py, sklearn, matplotlib, cv2, safetensors and tqdm import
     (printed; nothing is gated on it but the optional cases below);
  2. build: nvcc compiles the kernels from csrc/ (one process per source,
     in parallel; timed);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the main-path shapes and at a ragged small shape: the ViT attention
     kernels in float64 (rtol 1e-9, atol 1e-12) and float32, in exact FP32
     and in the tensor-parallel presets' modes (at 12 and 6 heads), the
     ViT block megakernels, the BERT layer kernels (float32 only; BERT-base
     at B=8, S=512 with each sample's mask cut at another length) and the
     tensor-parallel MLP kernels (ViT-B at B=8 with the shard widths of
     k = 1, 2, 4) in each preset's product modes, and the split path's MLP
     reverse (ViT-B at B=8) in its two mode pairs, all float32 results by
     the rule below against the float64 plain version (the MLP reverse by
     its 2-norm form); then the GEMM core alone (csrc/gemm.cu) at B8's
     and B6's eight product shapes and the ViT and BERT qkv and proj
     shapes, against precision.kdot on the same split operands in float64
     (elementwise within 1e-4 of |A|·|W|), and its instances of the
     tensor-parallel MLP kernels at their shapes (the fused passes, the
     grouped launch, bf16 A rows) the same way and bitwise the core's
     separate launches, and B10a / B10b bitwise their separate launches
     (fused = 0); phase 2 has shown its instances' registers (those of
     B10 by name), that none spills, and ptxas's remarks on wgmma and
     setmaxnreg,
     and that no instance of B5's row pass, of the column pass or of B4's
     tile as B2 instantiates it spills; B4 and B5 in the TP modes also at
     n = 29 and n = 261, and B5's probabilities bitwise B2's probs anchor
     from B2's own qkv; the rollout B1 in both its forms (the full product
     and its row 0, ``rows=1``) at ViT-B/16 and the ragged shape and, row-
     normalised, at BERT-base's n = 512 from start layers 11 and 0 and at
     n = 1031 (the wide instances' column passes), its per-head pass
     with grads at ViT-B/16, and without grads, row-normalised, at
     BERT-base's (8, 12, 12, 512, 512) from start layers 0 and 11 (the
     BERT rollout method's call); and every ViT kernel (B4, B5, B1's row
     form, B2 / B3 and B10 in both presets' modes, B6 in its two) at
     ViT-L/16's shapes (B=8, n=197, h=16, D=1024, M=4096, 24 blocks; B10
     at k = 1) and at DeiT-distilled's n = 198 by the same rules; B1-B5 at
     ViT-B/16 384 px (B=8, n=577): B1's row form in float64 and float32,
     B4 and B5 in float32 alone (their float64 instances need more shared
     memory than a block has at n = 577), B2 / B3 in both presets' modes;
  4. slices, each driven with the launch counts set to 0 just before and
     read just after: ``Explainer(params, VIT_BASE_16_224, device="cuda")``
     (exact FP32) and ``Explainer(..., **precision_kwargs("production"))``
     explain three batches of 8 images, and ``BertExplainer(params,
     BERT_BASE_UNCASED, ...)`` in both presets three batches of 8 padded
     sequences at S=512 (random weights from a seeded generator); output
     shape, finiteness, bitwise repeatability, launch counts per batch, and
     the per-sample Pearson correlation (BERT: over each sample's tokens)
     against the port's plain path of the same preset in float64 on the
     same card (exact FP32: >= 0.999 every sample; production: median >=
     0.999 and, for ViT, min no lower than the plain float32 production
     path's min - 0.01, for BERT no more samples below 0.99 than the plain
     float32 production path + 1); the production paths' corr against the
     exact float64 path is printed; the ViT split path
     (``block_kernel=False`` at the ``bfloat16`` preset: B4, B5 and B6 per
     block) on the same batches by the production gates against its own
     plain float64 path (its corr against the megakernel ``bfloat16`` path
     is printed); each of the nine ViT methods, and ``variant="lrp"`` and
     ``alpha=2`` of ``transformer_attribution``, in exact FP32 on the first
     batch (>= 0.999 every sample against the plain float64 run of the same
     method, or, where the plain float32 run also falls below 0.999, no
     lower than its corr - 0.01); each of the six BERT methods, and
     ``variant="lrp"`` and ``alpha=2`` of ``transformer_attribution``, in
     exact FP32 on the first BERT batch by the same gates over each
     sample's tokens; then the tensor-parallel program
     ``make_tp_explain_fn(VIT_BASE_16_224, ...)`` at k = 1 over a
     single-rank NCCL process group, in float32 and production, on the
     same batches by the ViT gates (its corr against the single-device
     slice is printed); ``with_diagnostics=True`` on the production path
     (heatmaps bitwise those without it, each sample's ``DIAG_FIELDS``
     finite where its heatmap is, each field's relative error against the
     plain float64 path printed), production with
     ``mlp_fwd_precision="bfloat16"`` and
     ``mlp_bwd_precision="tensorfloat32"`` by production's gates;
     ``VIT_LARGE_16_224`` and ``DEIT_BASE_DISTILLED_16_224`` (random
     weights from the seeded ``init_params``) in float32 and production,
     and DeiT's ``rollout_attn``, on the same batches, production and
     ViT-L's float32 by production's gates (at 24 blocks exact FP32 is
     ill-conditioned on some random-weight samples for any
     implementation), DeiT's float32 runs by the methods' rule (>= 0.999
     where the plain float32 path reaches it, else no lower than its corr
     - 0.01), the plain path's corr the lower of two float32 draws (the
     weights moved one float32 ulp); the tensor-parallel program on DeiT
     at k = 1 in float32 against the single-device plain float64 path by
     the same rule;
     checkpoints: the seeded parameters written under build/ as a flat
     timm .pth (ViT-B/16), a .pth with the state dict under "model"
     (DeiT-B distilled), the port's .npz (save_vit_npz) and BERT-base's
     pytorch_model.bin (and model.safetensors where phase 1 found
     safetensors), each loaded by ``create_model(name, checkpoint=path,
     device="cuda")`` and explained in production on the first batch: the
     maps bitwise those of the parameters passed directly;
     ViT-B/16 at 384 px (n = 577; the 224-px weights through
     ``adapt_pretrained``, fidelity_truth's 17 images resized to 384 on the
     card and 7 seeded noise images): float32 by the per-sample rule of
     DeiT's float32 runs (exact FP32 is ill-conditioned on one of these
     samples, for the plain path too) and production by production's
     gates, against the plain float64 path of the same preset;
     the harnesses at ViT-B/16's width on 32 images at 224 px (the 17 and
     15 seeded smooth ones, labels seeded smooth blobs): ``run_seg_eval``
     for transformer_attribution in float32 and production and rollout,
     full_lrp, lrp_last_layer, attn_last_layer and attn_gradcam in float32,
     each metric within SEG_GATES (0.01 float32, 0.03 production) of the
     same harness over the plain float64 path, or, where the plain float32
     path is further, within its distance + the gate, no NaN; then
     ``run_perturbation_eval`` positive and negative on the kernel path's
     transformer_attribution maps (visualize's ``saliency_maps``), the step
     accuracy within PERT_STEP_GATE (2/32) and the AUC within PERT_AUC_GATE
     (6.25) of the plain float64 forwards', and, where phase 1 found h5py,
     the same through ``compute_saliency_and_save`` -> results.hdf5 ->
     ``ImagenetResults`` (hits equal); every harness run's launch counts
     checked; images/s printed;
  5. times: each kernel beside its plain version and its bound, B4 beside
     ``scaled_dot_product_attention`` (and the CUDA kernel that call ran,
     from the profiler) and in the split path's bf16 mode, B5 in exact
     FP32 and in the TP production and split path modes (its launches
     from the profiler) and B2's attention-core launch, each beside its
     bound, B1's row form (the paths' call; the kernels line takes its
     launch's device time from the profiler), its
     full form and its per-head input (the head-mean pass's launch from the
     profiler; at ViT-B/16 and at BERT-base's shape, where one BERT
     ``rollout`` batch must launch the head-mean pass and the chain once
     each), B7 and B9 at
     S=512 and S=128, B7's attention-core launch (profiler) beside
     ``scaled_dot_product_attention`` with the additive mask on the same
     q, k, v at S=512, the GEMM core alone at the shapes checked in
     phase 3 (device time, TFLOP/s of bf16 passes) beside torch.matmul on
     the same bf16 operands (a yardstick: the port never calls it), B10a
     and B10b beside one bf16 torch.matmul per product over each phase's
     five products (summed), and
     each ViT kernel at ViT-L/16's shapes and at n = 198 beside its plain
     version and its bound there, explanations/s at B=8 for the
     exact-FP32 and the production paths, kernels and plain (ViT-B/16,
     ViT-L/16 and DeiT-distilled), the split
     path beside the megakernel ``bfloat16`` path, each method in exact FP32
     (BERT at S=512 and S=128, and each BERT method at S=512; the
     tensor-parallel program at k = 1); B1-B5 at n = 577 beside their
     plain versions and bounds.

It imports no JAX. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it the card's name and power limit, and the one before that
a JSON object with one entry per kernel (launches on the main paths, the
checkpoint, 384-px and harness runs included; error, kernel, plain, bound
and library times).
"""

import dataclasses
import importlib
import json
import os
import re
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
CORE_RTOL = 1e-4
TAIL_CORR = 0.99
# the harnesses' gates, fixed before their first chip run: each seg metric
# (pixAcc, mIoU, mAP, mF1) of the kernel path within SEG_GATES[preset] of
# the same harness over the plain float64 path, or, where the plain
# float32 path is itself further than that from it (a method whose exact
# FP32 answer is ill-conditioned on these inputs, as `full` is, PERF.md
# §6), within the plain float32 path's distance + SEG_GATES[preset]; the
# perturbation curve
# within PERT_STEP_GATE at every step (two of the 32 images) and its AUC
# within PERT_AUC_GATE points (the trapezoid of a curve moved by at most
# PERT_STEP_GATE everywhere, on the paper's x100 scale)
SEG_GATES = {"float32": 0.01, "production": 0.03}
PERT_STEP_GATE = 2 / 32
PERT_AUC_GATE = 100 * PERT_STEP_GATE
# the optional packages the port's readers and writers import lazily
OPTIONAL_PACKAGES = ("PIL", "h5py", "sklearn", "matplotlib", "cv2",
                     "safetensors", "tqdm")
TPU_KERNELS = "transformer_explainability_tpu/ops/pallas_kernels.py"
# the ViT methods whose map is a rollout chain (the rollout kernel B1)
ROLLOUT_METHODS = ("transformer_attribution", "grad", "rollout",
                   "rollout_attn")
# the BERT methods whose row is a rollout chain
BERT_ROLLOUT_METHODS = ("transformer_attribution", "rollout")
# the card's published rates (NVIDIA H100 SXM data sheet, dense, at a 700 W
# power limit): device memory, bf16 tensor cores, FP32 off the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


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
    t_start = time.perf_counter()
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
        DIAG_FIELDS, METHODS, explain_batch, precision_kwargs,
        uses_kernel_branch)
    from transformer_explainability_torch.models.vit import (
        DEIT_BASE_DISTILLED_16_224, VIT_BASE_16_224, VIT_LARGE_16_224,
        VisionTransformer, init_params)
    from transformer_explainability_torch.explain import (BertExplainer,
                                                          Explainer)
    from transformer_explainability_torch.explain import bert_generator as bg
    from transformer_explainability_torch.models import bert as bert_mod
    from transformer_explainability_torch.ops import _build
    from transformer_explainability_torch.ops import bert_math as bmath
    from transformer_explainability_torch.ops import block_math as bm
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.ops import precision as prec
    from transformer_explainability_torch.ops import relprop as rp
    from transformer_explainability_torch.parallel import (
        make_tp_explain_fn, shard_tp_params)
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
    have = {}
    for name in OPTIONAL_PACKAGES:
        try:
            importlib.import_module(name)
            have[name] = True
        except Exception:                  # missing, or broken on import
            have[name] = False
    print("optional packages importable: " + ", ".join(
        f"{name} {'yes' if ok else 'no'}" for name, ok in have.items()))

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s"
          f" (0 if cached)")
    log = so.parent / "build.log"
    if log.exists():
        # registers and spills per kernel (-Xptxas -v): a summary line, a
        # line for each kernel that spills and for each instance of the
        # redesigned kernels (B4's tile, also as B2 instantiates it, B7's
        # attention core, B5's, B9's and B3's row passes, the column pass
        # B3, B5 and B9 share); the GEMM core's instances (wgmma) in a
        # summary of their own, with every ptxas remark on wgmma (a
        # serialised wgmma pipeline is named there). No GEMM-core instance
        # may spill, and no instance of B5's row pass, of the column pass
        # or of B4's tile as B2 instantiates it
        entry, spill, regs, core_regs, core_spills = None, "", [], [], []
        remarks, redesign_spills = [], []
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "wgmma" in line or "setmaxnreg" in line:
                remarks.append(line.strip())
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                regs.append(int(line.split("Used")[1].split()[0]))
                clean = spill.startswith("0 bytes stack frame, 0 bytes spill")
                if "gemm_kernel" in entry:
                    core_regs.append(regs[-1])
                    if not clean:
                        core_spills.append(entry)
                    # the tensor-parallel MLP kernels' instances: the fused
                    # passes, the grouped launch (two GemmItems) and the
                    # products on bf16 A rows (SpecStd's last flag true)
                    if re.search(r"SpecTwoA|SpecDualAbsA|SpecThree|"
                                 r"SpecStdILi0ELb[01]ELb[01]ELb[01]ELb1E",
                                 entry):
                        print(f"  ptxas core (B10) {entry[:96]}: "
                              f"{regs[-1]} registers; {spill}")
                # B2's instances of B4's tile (the anchors: the last
                # template argument true), B5's row pass, the column pass,
                # B1's chain
                redesigned = bool(re.search(
                    r"attn_fwd_kernelI[fd]Lb[01]ELi\d+ELb1E", entry)) or (
                    "blk_attn_rev_cols_kernel" in entry) or (
                    "attn_rev_rows_kernel" in entry
                    and "blk_attn" not in entry and "bert_attn" not in entry
                    ) or "rollout_chain_kernel" in entry
                if redesigned and not clean:
                    redesign_spills.append(entry)
                if not clean or redesigned or any(k in entry for k in (
                        "attn_fwd_kernel", "bert_attn_rev_rows_kernel",
                        "blk_attn_rev_rows_kernel")):
                    print(f"  ptxas {entry[:72]}: {regs[-1]} registers; "
                          f"{spill}")
                entry = None
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers; the others spill nothing")
        print(f"  ptxas: {len(core_regs)} GEMM-core instances (wgmma), "
              f"{min(core_regs)}-{max(core_regs)} registers, "
              f"{len(core_spills)} spill")
        print(f"  ptxas: {len(remarks)} remarks on wgmma or setmaxnreg"
              + "".join(f"\n    {r[:300]}" for r in remarks[:4]))
        require(not core_spills, f"GEMM-core instances spill: {core_spills}")
        require(not redesign_spills,
                f"B2's attention core, B5's row or column pass or B1's "
                f"chain spill: "
                f"{redesign_spills}")

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")
    # 3. kernels against their plain versions --------------------------------
    cfg = VIT_BASE_16_224
    B, n, h, hd, L = 8, cfg.num_tokens, cfg.num_heads, cfg.head_dim, cfg.depth
    vit_eps = cfg.block_ln_eps
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

    def check_f64_f32(name, kern, plain, args64, label, main, f64=True,
                      **modes):
        """The kernel in float64 (rtol 1e-9 against the plain version) and
        in float32 (the rule above), both from the same inputs; with
        ``f64=False`` in float32 alone (a shape whose float64 instance one
        block's shared memory cannot hold)."""
        args32 = tuple(a.float() if torch.is_tensor(a) else a
                       for a in args64)
        before = kern.launches
        k32 = kern(*args32, **modes)
        k64 = kern(*args64, **modes) if f64 else None
        torch.cuda.synchronize()
        require(kern.launches == before + 1 + f64,
                f"{name}: launch count did not rise")
        p64, p32 = plain(*args64, **modes), plain(*args32, **modes)
        outs = lambda x: x if isinstance(x, tuple) else (x,)
        for i, (a32, b64, b32) in enumerate(zip(outs(k32), outs(p64),
                                                outs(p32))):
            require(torch.isfinite(a32).all().item(),
                    f"{name}[{i}] {label}: non-finite float32 output")
            e64 = float("nan")
            if f64:
                a64 = outs(k64)[i]
                e64 = (a64 - b64).abs().max().item()
                require(torch.allclose(a64, b64, rtol=F64_RTOL,
                                       atol=F64_ATOL),
                        f"{name}[{i}] {label}: float64 kernel differs from "
                        f"plain by {e64:.3e}")
            ek = (a32.double() - b64).abs().max().item()
            ep = (b32.double() - b64).abs().max().item()
            lim = F32_FACTOR * ep + F32_FLOOR * b64.abs().max().item()
            e32 = (a32 - b32).abs().max().item()
            print(f"check {name}[{i}] {label}: f64 max|k-p|={e64:.3e}; "
                  f"f32 max|k-p|={e32:.3e}, max|k32-p64|={ek:.3e} <= "
                  f"{lim:.3e} (plain f32 {ep:.3e})")
            require(ek <= lim, f"{name}[{i}] {label}: float32 kernel error "
                    f"{ek:.3e} above {lim:.3e}")
            if main:
                errs[name] = max(errs.get(name, 0.0), e32)

    for name, (make, kern, plain) in cases.items():
        for sname, shp in shapes.items():
            check_f64_f32(name, kern, plain, make(*shp, torch.float64),
                          f"{sname} {tuple(shp)}", sname == "main")
    # B1's row form (rows=1, the one every path calls) beside the full form
    # above, and its per-head pass with grads at ViT-B/16, each from the
    # same inputs in float64 and float32. Their own generator keeps the
    # inputs of every check below independent of them
    b1_gen = torch.Generator(device=dev).manual_seed(11)

    def b1_randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=b1_gen, device=dev,
                           dtype=torch.float64).to(dtype)

    _, kern, plain = cases["rollout_from_grad_cam"]
    for sname, (b, nn_, _, _) in shapes.items():
        check_f64_f32("rollout_from_grad_cam", kern, plain,
                      (b1_randn(b, L, nn_, nn_).abs() * 1e-3, 0),
                      f"rows=1 {sname} {(b, nn_)}", sname == "main", rows=1)
    heads = (b1_randn(B, L, h, n, n) * 1e-2, b1_randn(B, L, h, n, n))
    for start in (0, 3):
        check_f64_f32("rollout_from_grad_cam", kern, plain,
                      (heads[0], start, False, heads[1]),
                      f"per-head with grads start {start} rows=1 "
                      f"{(B, L, h, n)}", True, rows=1)
    del heads
    # above 1024 tokens both forms walk their columns in passes (the wide
    # instances): n = 1031, row-normalised
    for rows in (1, None):
        check_f64_f32("rollout_from_grad_cam", kern, plain,
                      (b1_randn(2, 3, 1031, 1031).abs() * 1e-3, 0, True),
                      f"wide rows={rows} (2, 3, 1031)", False, rows=rows)

    def f32_rule(name, k32, p32, p64, norm=False):
        """float32 kernel vs plain float32, both against plain float64: by
        the largest error, or with ``norm`` by the error's 2-norm relative
        to the float64 result's (the largest error is printed too)."""
        require(torch.isfinite(k32).all().item(),
                f"{name}: non-finite float32 output")
        ek = (k32.double() - p64).abs().max().item()
        ep = (p32.double() - p64).abs().max().item()
        lim = F32_FACTOR * ep + F32_FLOOR * p64.abs().max().item()
        e32 = (k32 - p32).abs().max().item()
        if norm:
            nk, npl = ((t.double() - p64).norm().item() / p64.norm().item()
                       for t in (k32, p32))
            nlim = F32_FACTOR * npl + F32_FLOOR
            print(f"check {name}: f32 max|k-p|={e32:.3e}, |k32-p64|/|p64|="
                  f"{nk:.3e} <= {nlim:.3e} (plain f32 {npl:.3e}); "
                  f"max|k32-p64|={ek:.3e} (plain f32 {ep:.3e})")
            require(nk <= nlim, f"{name}: float32 kernel error {nk:.3e} "
                    f"(2-norm, relative) above {nlim:.3e}")
            return e32
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

    def check_block(preset, sname, shp):
        """B2 and then B3 (from B2's float64 plain anchors) in ``preset``'s
        modes at ``shp`` = (B, n, h, hd); returns the float32 inputs of
        both calls (for the timings)."""
        mxu, attn, rule, mlp = block_modes[preset]
        b, nn_, hh, dd = shp
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
        return dict(p32=p32, x=x.float(), a32=a32, s32=s32, fargs=fargs,
                    rargs=rargs)

    block_inputs = {}
    for preset in block_modes:
        for sname, shp in shapes.items():
            kept = check_block(preset, sname, shp)
            if preset == "production" and sname == "main":
                block_inputs = kept
            del kept
    torch.cuda.empty_cache()

    # BERT layer kernels, in the same two presets' product modes, at the
    # BERT-base main shape and a ragged one; each sample's mask is cut at
    # another length
    bcfg = bert_mod.BERT_BASE_UNCASED
    bert_shapes = {"main": (8, 512, bcfg.num_heads, bcfg.head_dim,
                            bcfg.intermediate_size),
                   "ragged": (2, 29, 3, 8, 96)}

    def bert_case(b, S, hh, dd, inter, base):
        D = hh * dd

        def w(o, i):
            return randn(o, i, dtype=torch.float64) / i ** 0.5

        def vec(k, centre=0.0):
            return centre + 0.1 * randn(k, dtype=torch.float64)

        ws = [prec.prepare_weight(t, base)
              for t in (w(3 * D, D), w(D, D), w(inter, D), w(D, inter))]
        vecs = [vec(D, 1.0), vec(D), vec(D, 1.0), vec(D), vec(3 * D),
                vec(D), vec(inter), vec(D)]
        lengths = S - (S // b) * torch.arange(b, device=dev)
        keep = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        mask = (1.0 - keep.double()) * bcfg.mask_value
        return (bmath.BertLayerParams(*vecs, *ws),
                bmath.BertLayerParams(*[v.float() for v in vecs], *ws),
                randn(b, S, D, dtype=torch.float64), mask)

    def counted(kern, *args, **kw):
        before = kern.launches
        out = kern(*args, **kw)
        torch.cuda.synchronize()
        require(kern.launches == before + 1,
                f"{kern.__name__}: launch count did not rise")
        return out

    def check_all(name, preset, sname, shp, outs_k, outs_32, outs_64, names,
                  norm=False):
        for i, nm in enumerate(names):
            e = f32_rule(f"{name}[{nm}] {preset} {sname} {shp}", outs_k[i],
                         outs_32[i], outs_64[i], norm)
            if sname == "main":
                errs[name] = max(errs.get(name, 0.0), e)

    bert_inputs = {}
    eps = bcfg.layer_norm_eps
    for preset, (mxu, attn, rule, mlp) in block_modes.items():
        for sname, shp in bert_shapes.items():
            b, S, hh, dd, inter = shp
            p64, p32, x, mask = bert_case(*shp, mxu)
            x32, m32 = x.float(), mask.float()
            fargs = (hh, dd, eps, mxu, attn, mlp)
            k32 = counted(K.bert_layer_fwd_core, x32, m32, p32, *fargs,
                          save_attn=True)
            f64 = bmath.bert_layer_fwd_core_plain(x, mask, p64, *fargs,
                                                  save_attn=True)
            f32 = bmath.bert_layer_fwd_core_plain(x32, m32, p32, *fargs,
                                                  save_attn=True)
            check_all("bert_layer_fwd_core", preset, sname, shp, k32, f32,
                      f64, ["out", "att_ln", "qkv_pre", "ctx", "dense_nb"])
            # the reverse sub-blocks from the float64 forward's own anchors
            g_out, R = (randn(b, S, hh * dd, dtype=torch.float64)
                        for _ in range(2))
            o64 = (f64[1], g_out, R)
            o32 = tuple(t.float() for t in o64)
            oargs = (eps, mxu, rule, mlp)
            k32 = counted(K.bert_out_rev_core, *o32, p32, *oargs)
            r64 = bmath.bert_out_rev_core_plain(*o64, p64, *oargs)
            r32 = bmath.bert_out_rev_core_plain(*o32, p32, *oargs)
            check_all("bert_out_rev_core", preset, sname, shp, k32, r32, r64,
                      ["g_attln", "R_att"])
            a64 = (x, r64[0], r64[1], mask)
            a32 = tuple(t.float() for t in a64)
            s64, s32 = f64[2:], tuple(t.float() for t in f64[2:])
            aargs = (hh, dd, eps, mxu, attn, rule)
            k32 = counted(K.bert_attn_rev_core, *a32, p32, *aargs, saved=s32)
            r64 = bmath.bert_attn_rev_core_plain(*a64, p64, *aargs, saved=s64)
            r32 = bmath.bert_attn_rev_core_plain(*a32, p32, *aargs, saved=s32)
            check_all("bert_attn_rev_core", preset, sname, shp, k32, r32, r64,
                      ["g_in", "R_in", "gc"])
            if preset == "production" and sname == "main":
                bert_inputs = dict(p32=p32, x=x32, m=m32, o32=o32, a32=a32,
                                   s32=s32, fargs=fargs, oargs=oargs,
                                   aargs=aargs)
            del p64, p32, x, mask, k32, f64, f32, r64, r32
    # the rollout at BERT-base's length: one chain step (start_layer 11, the
    # BERT default) and the whole chain, row-normalised
    cams = rollout_inputs(8, bcfg.num_layers, 512, torch.float64)
    for start in (bcfg.num_layers - 1, 0):
        for rows in (None, 1):
            k64 = counted(K.rollout_from_grad_cam, cams, start, True,
                          rows=rows)
            k32 = counted(K.rollout_from_grad_cam, cams.float(), start, True,
                          rows=rows)
            p64 = K.rollout_plain(cams, start, True, rows=rows)
            e64 = (k64 - p64).abs().max().item()
            label = f"rollout_from_grad_cam n=512 start {start} rows={rows}"
            require(torch.allclose(k64, p64, rtol=F64_RTOL, atol=F64_ATOL),
                    f"{label}: float64 kernel differs from plain by "
                    f"{e64:.3e}")
            f32_rule(f"{label} (f64 max|k-p|={e64:.3e})", k32,
                     K.rollout_plain(cams.float(), start, True, rows=rows),
                     p64)
    del cams, k64, k32, p64
    # B1's per-head pass without grads, row-normalised, at BERT-base's
    # shape: the rollout method's call on every layer's probabilities
    # (softmax rows), from start layers 0 and 11; a generator of their own
    bh_gen = torch.Generator(device=dev).manual_seed(12)
    bprobs = torch.softmax(torch.randn(
        8, bcfg.num_layers, bcfg.num_heads, 512, 512, generator=bh_gen,
        device=dev, dtype=torch.float64), dim=-1)
    for start in (0, bcfg.num_layers - 1):
        check_f64_f32("rollout_from_grad_cam", K.rollout_from_grad_cam,
                      K.rollout_plain, (bprobs, start, True),
                      f"per-head rows=1 start {start} "
                      f"{tuple(bprobs.shape)}", True, rows=1)
    del bprobs
    torch.cuda.empty_cache()

    # the tensor-parallel path's kernels: B4 / B5 in the TP presets'
    # attention and rule modes at h/k = 12 and 6 heads; B10a / B10b at
    # ViT-B B=8 with the local MLP widths of k = 1, 2, 4 ("main" is k = 1)
    # and at ragged widths (D=776, M/k=1000: no multiple of a tile), in the
    # two presets' modes. Each shape is large: a product with bf16 operands
    # that the kernel computes (LayerNorm and GELU outputs, divides) rounds
    # a few of them to the neighbouring bf16 value where its float32 value
    # differs from the float64 one by an ulp. Over a million operands the
    # plain float32 version does so too and the rule below compares like
    # with like; over a few ten thousand (D=24, M/k=40 on the card) one such
    # rounding in the kernel alone fails it
    tp_attn = {"production": ("float32", "bfloat16"),
               "bfloat16": ("bfloat16", "bfloat16")}
    for preset, (attn, rule) in tp_attn.items():
        # also at the ragged shape and above 256 keys (B4's and B5's
        # softmax over shared memory, B5's smaller query tiles)
        for sname, shp in (("h=12", (B, n, h, hd)),
                           ("h=6", (B, n, h // 2, hd)),
                           ("ragged", shapes["ragged"]),
                           ("n=261", (2, 261, 3, hd))):
            label = f"{preset} {sname} {tuple(shp)}"
            make, kern, plain = cases["attn_fwd_core"]
            check_f64_f32("attn_fwd_core", kern, plain,
                          make(*shp, torch.float64), label, False, mxu=attn)
            make, kern, plain = cases["attn_rev_core"]
            check_f64_f32("attn_rev_core", kern, plain,
                          make(*shp, torch.float64), label, False,
                          attn_mxu=attn, rule_mxu=rule)
    # B5 recomputes the probabilities by B4's tile, the function whose
    # anchor instance saves B2's: from B2's own qkv (qkv_pre + bqkv, as its
    # epilogue adds them) B5's P must be bitwise B2's probs (a direct call
    # of B5's C entry, which keeps its scratch maps; not counted)
    lib = _build.load_library()
    for preset, (mxu, attn, rule, mlp) in block_modes.items():
        _, p32, x, _, _ = block_case(B, n, h, hd, mxu)
        fwd = K.block_fwd_core(x.float(), p32, h, hd, vit_eps, mxu, attn,
                               mlp, save_attn=True)
        qkv = fwd[3] + p32.bqkv
        g_o, cam_o = (randn(B, n, h * hd, dtype=torch.float32)
                      for _ in range(2))
        outs = [torch.empty_like(qkv), torch.empty_like(qkv),
                torch.empty(B, n, n, device=dev)]
        maps = [torch.empty(B, h, n, n, device=dev) for _ in range(4)]
        S1 = torch.empty(B, h, n, hd, device=dev)
        code = lib.te_attn_rev_f32(
            *[t.data_ptr() for t in (qkv, g_o, cam_o, *outs, *maps, S1)], B,
            n, h, hd, hd ** -0.5, K._ATTN_BF16[attn], K._ATTN_BF16[rule],
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        require(code == 0, f"attn_rev_core C entry failed ({code})")
        same = torch.equal(maps[0].view(torch.int32),
                           fwd[6].view(B, h, n, n).view(torch.int32))
        print(f"check B5's P vs B2's probs {preset} {(B, n, h, hd)}: "
              f"{'bitwise equal' if same else 'DIFFER'}")
        require(same, f"B5's probabilities are not bitwise B2's ({preset})")
        del p32, x, fwd, qkv, g_o, cam_o, outs, maps, S1

    # (weight preparation, MLP mode, rule mode) of the presets
    tp_mlp = {"production": ("tensorfloat32", "bfloat16", "bfloat16"),
              "bfloat16": ("bfloat16", "bfloat16", "bfloat16")}
    D, M = cfg.embed_dim, cfg.mlp_dim
    tp_shapes = {"main": (B, n, D, M), "k=2": (B, n, D, M // 2),
                 "k=4": (B, n, D, M // 4), "ragged": (B, n, 776, 1000)}

    def check_b10(preset, sname, shp):
        """B10a and then B10b (from B10a's float64 plain anchor) in
        ``preset``'s modes at ``shp`` = (B, n, D, M/k), and their fused
        passes bitwise the separate launches; returns the float32 inputs
        (for the timings)."""
        base, mlp, rule = tp_mlp[preset]
        b, nn_, dd, ml = shp
        w1 = prec.prepare_weight(randn(ml, dd, dtype=torch.float64)
                                 / dd ** 0.5, base)
        w2 = prec.prepare_weight(randn(dd, ml, dtype=torch.float64)
                                 / ml ** 0.5, base)
        vecs = (1.0 + 0.1 * randn(dd, dtype=torch.float64),
                0.1 * randn(dd, dtype=torch.float64),
                0.1 * randn(ml, dtype=torch.float64))
        x = randn(b, nn_, dd, dtype=torch.float64, offset=0.5)
        a64 = (x, randn(b, nn_, dd, dtype=torch.float64), *vecs)
        a32 = tuple(t.float() for t in a64)
        k32 = counted(K.mlp_rev_tp_phase1, *a32, w1, w2, vit_eps, mlp, rule)
        p64 = K.mlp_rev_tp_phase1_plain(*a64, w1, w2, vit_eps, mlp, rule)
        p32 = K.mlp_rev_tp_phase1_plain(*a32, w1, w2, vit_eps, mlp, rule)
        check_all("mlp_rev_tp_phase1", preset, sname, shp, k32, p32, p64,
                  ["fc1_pre", "fc2_pre", "axw2", "g_xn2"])
        # phase 2 from the float64 phase 1's anchor, with the fc2 rule's
        # divide formed as the TP program forms it
        Sr = rp.safe_divide(randn(b, nn_, dd, dtype=torch.float64),
                            0.5 * (p64[1] + p64[2]))
        b64 = (x, Sr, p64[0], *vecs)
        b32 = tuple(t.float() for t in b64)
        k32 = counted(K.mlp_rev_tp_phase2, *b32, w1, w2, vit_eps, rule)
        q64 = K.mlp_rev_tp_phase2_plain(*b64, w1, w2, vit_eps, rule)
        q32 = K.mlp_rev_tp_phase2_plain(*b32, w1, w2, vit_eps, rule)
        check_all("mlp_rev_tp_phase2", preset, sname, shp, k32, q32, q64,
                  ["num_w", "num_a"])
        # the fused passes (the presets' modes) bitwise the separate
        # launches (fused = 0) on the same inputs (direct calls of the C
        # entries: not counted)
        flags = K._tp_modes("mlp_rev_tp_phase1", a32[0], (w1, w2), mlp=mlp,
                            rule=rule)
        st = torch.cuda.current_stream().cuda_stream
        f1 = K._launch_mlp_rev_tp1(lib, *a32, w1, w2, vit_eps, flags, st)
        u1 = K._launch_mlp_rev_tp1(lib, *a32, w1, w2, vit_eps, flags, st,
                                   fused=False)
        f2 = K._launch_mlp_rev_tp2(lib, *b32, w1, w2, vit_eps,
                                   {"rule": flags["rule"]}, st)
        u2 = K._launch_mlp_rev_tp2(lib, *b32, w1, w2, vit_eps,
                                   {"rule": flags["rule"]}, st, fused=False)
        torch.cuda.synchronize()
        same = [torch.equal(x_.view(torch.int32), y_.view(torch.int32))
                for x_, y_ in zip((*f1, *f2), (*u1, *u2))]
        print(f"check mlp_rev_tp {preset} {sname} {shp}: fused passes "
              f"vs separate launches, outputs bitwise equal: {same}")
        require(all(same), f"mlp_rev_tp {preset} {sname}: the fused "
                f"passes are not bitwise the separate launches")
        return dict(a32=a32, b32=b32, w=(w1, w2), mlp=mlp, rule=rule)

    tp_inputs = {}
    for preset in tp_mlp:
        for sname, shp in tp_shapes.items():
            kept = check_b10(preset, sname, shp)
            if preset == "production" and sname == "main":
                tp_inputs = kept
            del kept
    torch.cuda.empty_cache()

    # the split path's MLP reverse B6 at ViT-B B=8 and at the same ragged
    # widths as B10, in its two (MLP, rule) mode pairs: the bfloat16
    # preset's (the split path) and bf16x3 MLP products with bf16 rules.
    # The kernel takes float32 only (as B2, B3 and B10 do): its float32
    # result is held to the float64 plain version by the rule above in its
    # 2-norm form. B6 recomputes fc1_pre and fc2_pre and rounds their
    # successors (hg, the rule quotients) to bf16 again, so each
    # implementation moves its own few operands to the other bf16
    # neighbour, and each such move shifts a block output by up to ≈ 3e-3
    # (more where the add rule divides by a small output). The largest
    # error is then a draw of where those moves land, the kernel's and the
    # plain float32 version's each their own (seen on an H100: 4.4e-2 vs
    # 3.2e-3 in one draw, 4.6e-3 vs 1.7e-2 in the next); the 2-norm
    # compares their size, which is what the kernel sets
    b6_modes = {"bf16/bf16": ("bfloat16", "bfloat16"),
                "tf32/bf16": ("tensorfloat32", "bfloat16")}

    def check_b6(mname, sname, shp):
        """B6 in the (MLP, rule) mode pair ``mname`` at ``shp`` = (B, n, D,
        M); returns the float32 inputs (for the timings)."""
        mlp, rule = b6_modes[mname]
        b, nn_, dd, ml = shp
        w1 = prec.prepare_weight(randn(ml, dd, dtype=torch.float64)
                                 / dd ** 0.5, mlp)
        w2 = prec.prepare_weight(randn(dd, ml, dtype=torch.float64)
                                 / ml ** 0.5, mlp)
        vecs = (1.0 + 0.1 * randn(dd, dtype=torch.float64),
                *(0.1 * randn(k, dtype=torch.float64) for k in (dd, ml, dd)))
        z = torch.zeros(1, device=dev)      # attention half: not read

        def b6_params(ln2s, ln2b, b1, b2):
            return bm.BlockParams(z, z, ln2s, ln2b, z, z, b1, b2, None, None,
                                  w1, w2)

        q64 = b6_params(*vecs)
        q32 = b6_params(*(v.float() for v in vecs))
        # x_mid around 4 (spread 0.5), so that x_mid and the block output
        # x_mid + mlp_out (spread ≈ 0.65 here) stay away from 0: the add
        # rule divides by the output and the clone by x_mid, and near 0
        # those divisions amplify the summation order of the recomputed
        # fc1 / fc2 products (kernel and plain versions each have their
        # own), so the comparison would measure their conditioning instead
        # of the kernel
        a64 = (4.0 + 0.5 * randn(b, nn_, dd, dtype=torch.float64),
               *(randn(b, nn_, dd, dtype=torch.float64)
                 for _ in range(2)))          # x_mid, g_out, R
        a32 = tuple(t.float() for t in a64)
        k32 = counted(K.mlp_rev_core, *a32, q32, vit_eps, mlp, rule)
        p64 = K.mlp_rev_core_plain(*a64, q64, vit_eps, mlp, rule)
        p32 = K.mlp_rev_core_plain(*a32, q32, vit_eps, mlp, rule)
        check_all("mlp_rev_core", mname, sname, shp, k32, p32, p64,
                  ["g_mid", "Rm"], norm=True)
        return dict(a32=a32, p32=q32, mlp=mlp, rule=rule)

    b6_inputs = {}
    for mname in b6_modes:
        for sname in ("main", "ragged"):
            kept = check_b6(mname, sname, tp_shapes[sname])
            if mname == "bf16/bf16" and sname == "main":
                b6_inputs = kept
            del kept
    torch.cuda.empty_cache()

    # the GEMM core alone (csrc/gemm.cu, a store epilogue) at the main paths'
    # shapes, in the instances and modes the layer kernels launch there: the
    # eight products of B8 (BERT-base B=8, S=512) and of B6 (ViT-B/16 B=8,
    # the split path), in bf16 as production and the split path run them,
    # and the qkv and proj forward products of both models in bf16x3
    # (production's matmul mode). Each is held to its plain version
    # (precision.kdot on the same split operands) in float64, elementwise
    # within CORE_RTOL of |A|·|W| (float32 accumulation over K ≤ 3072 on the
    # tensor cores; a wrong layout, descriptor or ragged edge errs by the
    # size of the product itself); the plain float32 version's error
    # (cuBLAS on the same operands) and the mean signed relative error (the
    # accumulation's bias) are printed beside it
    def mlp_products(D_, M_):
        # (label, wt, absolute, dual, N, K) of one MLP reverse's 8 launches
        return [("x.W1t", 1, 0, 0, M_, D_), ("h.W2t", 1, 0, 0, D_, M_),
                ("g.W2", 0, 0, 0, M_, D_), ("g.W1", 0, 0, 0, D_, M_),
                ("|h|.|W2|t", 1, 1, 0, D_, M_), ("S.W2 dual", 0, 0, 1, M_, D_),
                ("|x|.|W1|t", 1, 1, 0, M_, D_), ("S.W1 dual", 0, 0, 1, D_, M_)]
    Dc, Mc, Sc = cfg.embed_dim, cfg.mlp_dim, bcfg.max_position_embeddings
    core_shapes = []
    for kname, rows in (("B8", 8 * Sc), ("B6", B * n)):
        core_shapes += [(f"{kname} {lab}", rows, *prod_, "bfloat16")
                        for lab, *prod_ in mlp_products(Dc, Mc)]
    for mname, rows in (("ViT", B * n), ("BERT", 8 * Sc)):
        core_shapes += [(f"{mname} qkv", rows, 1, 0, 0, 3 * Dc, Dc,
                         "tensorfloat32"),
                        (f"{mname} proj", rows, 1, 0, 0, Dc, Dc,
                         "tensorfloat32")]
    core_inputs = {}
    for label, rows, wt, ab, du, N_, K_, mode in core_shapes:
        a = randn(rows, K_, dtype=torch.float32)
        w64 = randn(*((N_, K_) if wt else (K_, N_)),
                    dtype=torch.float64) / K_ ** 0.5
        w = prec.prepare_weight(w64, mode)
        cargs = (mode, bool(wt), bool(ab), bool(du))
        k32 = counted(K.gemm_core, a, w, *cargs)
        p64 = K.gemm_core_plain(a.double(), w, *cargs)
        p32 = K.gemm_core_plain(a, w, *cargs)
        wv = sum(t.double() for t in w).abs()
        mag = a.double().abs() @ (wv.t() if wt else wv)
        outs = (lambda x: x if du else (x,))
        for i, (k_, q64, q32) in enumerate(zip(outs(k32), outs(p64),
                                               outs(p32))):
            rel = (k_.double() - q64) / mag
            relp = ((q32.double() - q64) / mag).abs().max().item()
            e = rel.abs().max().item()
            print(f"check core {label}[{i}] ({rows}, {N_}, {K_}) {mode}: "
                  f"max|k-p64|/(|A||W|)={e:.3e} <= {CORE_RTOL:.0e} (plain "
                  f"f32 {relp:.3e}); mean (k-p64)/(|A||W|) "
                  f"{rel.mean().item():+.3e}")
            require(e <= CORE_RTOL, f"core {label}[{i}]: error {e:.3e} of "
                    f"|A|·|W| above {CORE_RTOL:.0e}")
        core_inputs[label] = (a, w, cargs, (rows, N_, K_))
        del w64, k32, p64, p32, wv, mag
    # the tensor-parallel MLP kernels' instances of the core at B10's shapes
    # (ViT-B/16 B=8, k = 1; bf16 products): the fused passes (kernels.
    # FUSED_KINDS: B10a's two-operand pass and its grouped launch, the dual
    # pass on |A| alone, B10b's three-set pass) and the dual on bf16 A rows
    # (B10b's last launch), each held to its plain version as above and
    # bitwise to the core's separate launches on float32 rows holding the
    # same bf16 values (each output's chain over k is the same)
    R10, D10, M10 = B * n, Dc, Mc

    def tp_weight(*shape):
        return prec.prepare_weight(randn(*shape, dtype=torch.float64)
                                   / shape[0 if len(shape) == 1 else 1] ** 0.5,
                                   "bfloat16")

    def rows_bf16(k_):
        return randn(R10, k_, dtype=torch.float32).to(torch.bfloat16)

    # kind: (a0, w0, a1, w1, (M, N, K), each output's (A, W, transposed))
    fused_cases = {}
    a0, w0, a1, w1 = (rows_bf16(D10), tp_weight(M10, D10), rows_bf16(D10),
                      tp_weight(D10, M10))
    fused_cases["two_a"] = (a0, w0, a1, w1, (R10, M10, D10),
                            [(a0, w0, True), (a1, w1, False)])
    a0, w0, a1, w1 = (rows_bf16(M10), tp_weight(D10, M10), rows_bf16(M10),
                      tp_weight(M10, D10))
    fused_cases["dual_abs_a"] = (a0, w0, None, None, (R10, D10, M10),
                                 [(a0, w0, True)] * 2)
    fused_cases["group"] = (a0, w0, a1, w1, (R10, D10, M10),
                            [(a0, w0, True)] * 2 + [(a1, w1, False)])
    a0, w0, a1, w1 = (rows_bf16(D10), tp_weight(D10, M10), rows_bf16(D10),
                      tp_weight(M10, D10))
    fused_cases["three"] = (a0, w0, a1, w1, (R10, M10, D10),
                            [(a0, w0, False)] * 2 + [(a1, w1, True)])
    a0, w0 = rows_bf16(M10), tp_weight(M10, D10)
    fused_cases["bf16 A dual"] = (a0, w0, None, None, (R10, D10, M10),
                                  [(a0, w0, False)] * 2)
    fused_inputs = {}
    stream = torch.cuda.current_stream().cuda_stream
    sep = lambda a, w, wt, ab=False, du=False: K._launch_gemm(
        lib, a.float(), w, 0, wt, ab, du, -1, stream)
    for kind, (a0, w0, a1, w1, (M_, N_, K_), ops) in fused_cases.items():
        if kind == "bf16 A dual":
            k_ = counted(K.gemm_core, a0, w0, "bfloat16", False, False, True)
            p_ = K.gemm_core_plain(a0.double(), w0, "bfloat16", False, False,
                                   True)
            s_ = sep(a0, w0, False, du=True)
        else:
            before = K.gemm_core.launches
            k_ = K.gemm_core_fused(kind, a0, w0, a1, w1)
            torch.cuda.synchronize()
            require(K.gemm_core.launches == before + 1,
                    "gemm_core_fused: launch count did not rise")
            p_ = K.gemm_core_fused_plain(
                kind, a0.double(), w0, None if a1 is None else a1.double(),
                w1)
            s_ = {"two_a": lambda: (sep(a0, w0, True), sep(a1, w1, False)),
                  "dual_abs_a": lambda: (sep(a0, w0, True),
                                         sep(a0, w0, True, True)),
                  "three": lambda: (*sep(a0, w0, False, du=True),
                                    sep(a1, w1, True, True)),
                  "group": lambda: (sep(a0, w0, True), sep(a0, w0, True, True),
                                    sep(a1, w1, False))}[kind]()
        torch.cuda.synchronize()
        for i, (kk, pp, ss, (a_, w_, t_)) in enumerate(zip(k_, p_, s_, ops)):
            wv = sum(t.double() for t in w_).abs()
            mag = a_.double().abs() @ (wv.t() if t_ else wv)
            e = ((kk.double() - pp) / mag).abs().max().item()
            same = torch.equal(kk.view(torch.int32), ss.view(torch.int32))
            print(f"check core B10 {kind}[{i}] ({M_}, {N_}, {K_}) bfloat16: "
                  f"max|k-p64|/(|A||W|)={e:.3e} <= {CORE_RTOL:.0e}; "
                  f"{'bitwise' if same else 'NOT bitwise'} the separate "
                  f"launch")
            require(e <= CORE_RTOL, f"core B10 {kind}[{i}]: error {e:.3e} "
                    f"of |A|·|W| above {CORE_RTOL:.0e}")
            require(same, f"core B10 {kind}[{i}]: not bitwise the separate "
                    f"launch")
        fused_inputs[kind] = (a0, w0, a1, w1, (M_, N_, K_), len(ops))
        del k_, p_, s_
    torch.cuda.empty_cache()

    # the other configurations' shapes: ViT-L/16 (B=8, n=197, h=16, hd=64,
    # D=1024, M=4096, 24 blocks; B10 at k = 1) and DeiT-base distilled
    # (ViT-B's widths at n = 198: CLS, DIST and 196 patches). Every kernel
    # of their paths against its plain version by the rules above: B4, B5
    # and B1's row form from float64 inputs in exact FP32, B2 / B3 and B10
    # in both presets' modes, B6 in the split path's pair (bf16/bf16), the
    # only one a path runs. Their errors are printed, not carried into the
    # kernels line (ViT-B's main shapes). (B6's other pair, bf16x3 MLP
    # products with bf16 rules, is checked at ViT-B only: at ViT-L its Rm
    # misses the 2-norm rule, ROADMAP C5)
    new_shapes = {
        "ViT-L": (B, VIT_LARGE_16_224.num_tokens, VIT_LARGE_16_224.num_heads,
                  VIT_LARGE_16_224.head_dim, VIT_LARGE_16_224.depth),
        "n=198": (B, DEIT_BASE_DISTILLED_16_224.num_tokens,
                  DEIT_BASE_DISTILLED_16_224.num_heads,
                  DEIT_BASE_DISTILLED_16_224.head_dim,
                  DEIT_BASE_DISTILLED_16_224.depth)}
    new_inputs = {}
    for sname, (b, nn_, hh, dd, ll) in new_shapes.items():
        shp, dm = (b, nn_, hh, dd), (b, nn_, hh * dd, 4 * hh * dd)
        for name in ("attn_fwd_core", "attn_rev_core"):
            make, kern, plain = cases[name]
            check_f64_f32(name, kern, plain, make(*shp, torch.float64),
                          f"{sname} {shp}", False)
        check_f64_f32("rollout_from_grad_cam", K.rollout_from_grad_cam,
                      K.rollout_plain,
                      (randn(b, ll, nn_, nn_, dtype=torch.float64).abs()
                       * 1e-3, 0), f"rows=1 {sname} {(b, ll, nn_)}", False,
                      rows=1)
        kept = {f"block {preset}": check_block(preset, sname, shp)
                for preset in block_modes}
        kept.update({f"b10 {preset}": check_b10(preset, sname, dm)
                     for preset in tp_mlp})
        new_inputs[sname] = dict(block=kept["block production"],
                                 b10=kept["b10 production"],
                                 b6=check_b6("bf16/bf16", sname, dm))
        del kept
        torch.cuda.empty_cache()
    # ViT-B/16 at 384 px (n = 577, timm's vit_base_patch16_384 geometry):
    # the kernels of its float32 and production paths, B4, B5 and B1's row
    # form from float64 inputs and B2 / B3 in both presets' modes, by the
    # rules above. B4's and B5's float64 instances need more shared memory
    # at n = 577 than a block has (357 and 414 KB against 227 KB), so those
    # two are checked in float32 alone, against the float64 plain version
    shape577 = (B, 577, h, hd)
    for name in ("attn_fwd_core", "attn_rev_core"):
        make, kern, plain = cases[name]
        check_f64_f32(name, kern, plain, make(*shape577, torch.float64),
                      f"n=577 {shape577}", False, f64=False)
    check_f64_f32("rollout_from_grad_cam", K.rollout_from_grad_cam,
                  K.rollout_plain,
                  (randn(B, L, 577, 577, dtype=torch.float64).abs() * 1e-3,
                   0), f"rows=1 n=577 {(B, L, 577)}", False, rows=1)
    block577 = {preset: check_block(preset, "n=577", shape577)
                for preset in block_modes}["production"]
    torch.cuda.empty_cache()

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")
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

    def drive(explain, batches, shape, per_batch, label, finite=True):
        """Explain the three batches twice each (counts set to 0 before,
        read after); returns the heatmaps and the counts. ``finite=False``
        leaves finiteness to the caller (a method whose answer is 0/0 on
        some inputs); repeatability is bitwise, NaNs included."""
        K.reset_launch_counts()
        heats = []
        for k, batch in enumerate(batches):
            c0 = K.launch_counts()
            heat = explain(*batch)
            torch.cuda.synchronize()
            c1 = K.launch_counts()
            rose = {w: c1[w] - c0[w] for w in c1}
            require(rose == per_batch,
                    f"{label} batch {k}: launch counts rose by {rose}")
            require(tuple(heat.shape) == shape,
                    f"{label} batch {k}: shape {tuple(heat.shape)}")
            require(torch.isfinite(heat).all().item() or not finite,
                    f"{label} batch {k}: non-finite")
            again = explain(*batch)
            require(torch.equal(heat.contiguous().view(torch.uint8),
                                again.contiguous().view(torch.uint8)),
                    f"{label} batch {k}: not bitwise repeatable")
            heats.append(heat)
        counts = K.launch_counts()
        print(f"{label} slice launches: {counts}")
        return heats, counts

    none = {w: 0 for w in K.launch_counts()}
    vit_shape = (8, cfg.num_patches)
    heats, launches = drive(ex.explain, batches, vit_shape,
                            {**none, "attn_fwd_core": L, "attn_rev_core": L,
                             "rollout_from_grad_cam": 1}, "float32")
    prod = precision_kwargs("production")
    ex_prod = Explainer(params, cfg, device="cuda", **prod)
    heats_prod, launches_prod = drive(
        ex_prod.explain, batches, vit_shape,
        {**none, "block_fwd_core": L, "block_rev_core": L,
         "rollout_from_grad_cam": 1}, "production")

    def corr(x, y):
        a = x.double() - x.double().mean(dim=1, keepdim=True)
        b = y - y.mean(dim=1, keepdim=True)
        return ((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).tolist()

    def fmt(a):
        return np.array2string(a, precision=6, max_line_width=1000)

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

    # the split path: the bfloat16 preset with the block kernels off (B4,
    # B5 and B6 per block, the products outside them in bf16), gated as
    # production is, against its own plain float64 version; its corr
    # against the megakernel bfloat16 path is printed
    bf16 = precision_kwargs("bfloat16")
    split = dict(bf16, block_kernel=False)
    ex_split = Explainer(params, cfg, device="cuda", **split)
    heats_split, launches_split = drive(
        ex_split.explain, batches, vit_shape,
        {**none, "attn_fwd_core": L, "attn_rev_core": L, "mlp_rev_core": L,
         "rollout_from_grad_cam": 1}, "split bfloat16")
    ex_bf16 = Explainer(params, cfg, device="cuda", **bf16)
    heats_bf16, launches_bf16 = drive(
        ex_bf16.explain, batches, vit_shape,
        {**none, "block_fwd_core": L, "block_rev_core": L,
         "rollout_from_grad_cam": 1}, "bfloat16")
    s_corrs, s_plain_corrs, s_mega = [], [], []
    for (imgs, idx), heat, heat_m in zip(batches, heats_split, heats_bf16):
        idx_t = torch.as_tensor(idx, device=dev)
        ref_s = explain_batch(model64, torch.as_tensor(
            imgs, device=dev, dtype=torch.float64), idx_t, ops=K.PLAIN_OPS,
            **split)
        s_corrs += corr(heat, ref_s)
        s_plain_corrs += corr(explain_batch(
            ex_split.model, torch.as_tensor(imgs, device=dev), idx_t,
            ops=K.PLAIN_OPS, **split), ref_s)
        s_mega += corr(heat, heat_m.double())
    s_corrs, s_plain_corrs, s_mega = map(np.asarray, (s_corrs, s_plain_corrs,
                                                      s_mega))
    print(f"split bfloat16 slice corr vs plain split f64 on the card: min "
          f"{s_corrs.min():.6f} median {np.median(s_corrs):.6f} (plain f32 "
          f"split path: min {s_plain_corrs.min():.6f} median "
          f"{np.median(s_plain_corrs):.6f}); per sample "
          f"{np.array2string(s_corrs, precision=6, max_line_width=1000)}")
    print(f"split bfloat16 slice corr vs the megakernel bfloat16 path, not "
          f"gated: min {s_mega.min():.6f} median {np.median(s_mega):.6f}; "
          f"per sample "
          f"{np.array2string(s_mega, precision=6, max_line_width=1000)}")
    require(np.median(s_corrs) >= MIN_CORR,
            f"split median corr {np.median(s_corrs):.6f} below {MIN_CORR}")
    require(s_corrs.min() >= s_plain_corrs.min() - PROD_MIN_SLACK,
            f"split min corr {s_corrs.min():.6f} below the plain f32 split "
            f"path's {s_plain_corrs.min():.6f} - {PROD_MIN_SLACK}")
    del ex_split, ex_bf16

    def ulp_moved(sd, seed):
        """A float32 state dict with every element moved to a float32
        neighbour, up or down at random (seeded): the same function in
        another float32 draw."""
        g = torch.Generator(device=dev).manual_seed(seed)
        inf = torch.tensor(float("inf"), device=dev)
        return {k: torch.where(torch.rand(v.shape, generator=g, device=dev)
                               < 0.5, torch.nextafter(v, inf),
                               torch.nextafter(v, -inf))
                for k, v in sd.items()}

    def preset_corrs(model32, model64_, heats_, kw, moved32=None):
        """Per-sample corr of the kernel path's heatmaps, and of the plain
        float32 path's (and, with ``moved32``, of the plain float32 path's
        on the weights moved one float32 ulp), against the plain float64
        path of the same arguments (preset, method) on the three
        batches."""
        c, c_plain, c_moved = [], [], []
        for (imgs, idx), heat in zip(batches, heats_):
            idx_t = torch.as_tensor(idx, device=dev)
            ref = explain_batch(model64_, torch.as_tensor(
                imgs, device=dev, dtype=torch.float64), idx_t,
                ops=K.PLAIN_OPS, **kw)
            c += corr(heat, ref)
            img32 = torch.as_tensor(imgs, device=dev)
            c_plain += corr(explain_batch(model32, img32, idx_t,
                                          ops=K.PLAIN_OPS, **kw), ref)
            if moved32 is not None:
                c_moved += corr(explain_batch(moved32, img32, idx_t,
                                              ops=K.PLAIN_OPS, **kw), ref)
        return (np.asarray(c), np.asarray(c_plain),
                np.asarray(c_moved) if moved32 is not None else None)

    def gate(label, c, c_plain, kind, c_moved=None):
        """ViT-B's gates: ``median`` (production's) median >= MIN_CORR and
        min no lower than the plain float32 path's min - PROD_MIN_SLACK;
        ``per-sample`` (exact FP32, as the ViT methods are held) >=
        MIN_CORR on every sample where the plain float32 path reaches
        MIN_CORR, and no lower than the plain float32 path's corr -
        PROD_MIN_SLACK on a sample where it does not (exact FP32 is
        ill-conditioned there for these random weights, whatever the
        implementation). With
        ``c_moved`` (the plain float32 path on the weights moved one
        float32 ulp: a second float32 draw) the plain path's corr is the
        lower of its two draws."""
        moved = "" if c_moved is None else (
            f", on weights moved one float32 ulp {fmt(c_moved)}")
        if c_moved is not None:
            c_plain = np.minimum(c_plain, c_moved)
        print(f"{label} corr vs plain f64 on the card: min {c.min():.6f} "
              f"median {np.median(c):.6f} over {len(c)} samples (plain f32 "
              f"path: min {c_plain.min():.6f} median "
              f"{np.median(c_plain):.6f}, below {MIN_CORR} on "
              f"{int((c_plain < MIN_CORR).sum())}); per sample {fmt(c)}, "
              f"plain f32 path {fmt(c_plain)}{moved}")
        if kind == "median":
            require(np.median(c) >= MIN_CORR, f"{label}: median corr "
                    f"{np.median(c):.6f} below {MIN_CORR}")
            require(c.min() >= c_plain.min() - PROD_MIN_SLACK,
                    f"{label}: min corr {c.min():.6f} below the plain f32 "
                    f"path's {c_plain.min():.6f} - {PROD_MIN_SLACK}")
        else:
            floor = np.where(c_plain >= MIN_CORR, MIN_CORR,
                             c_plain - PROD_MIN_SLACK)
            require((c >= floor).all(), f"{label}: per-sample corr {fmt(c)}"
                    f" below {fmt(floor)}")

    # the guarded mode's diagnostics on the production kernel path: the
    # heatmaps bitwise those of the calls without them (above), each
    # sample's DIAG_FIELDS finite where its heatmap is; each field's
    # relative error against the plain float64 path's diagnostics printed,
    # not gated
    per_prod = {**none, "block_fwd_core": L, "block_rev_core": L,
                "rollout_from_grad_cam": 1}
    diags = []

    def explain_diag(im, ix):
        heat, diag = ex_prod.explain(im, ix, with_diagnostics=True)
        diags.append(diag)
        return heat

    heats_diag, launches_diag = drive(explain_diag, batches, vit_shape,
                                      per_prod, "production with diagnostics")
    for k, (a, b_) in enumerate(zip(heats_diag, heats_prod)):
        require(torch.equal(a.contiguous().view(torch.uint8),
                            b_.contiguous().view(torch.uint8)),
                f"production batch {k}: the heatmap with diagnostics is not "
                f"bitwise the one without")
        require(torch.equal(diags[2 * k].view(torch.int32),
                            diags[2 * k + 1].view(torch.int32)),
                f"production batch {k}: diagnostics not bitwise repeatable")
    d_k = torch.cat(diags[0::2]).double()

    def plain_diag(model_, dtype):
        return torch.cat([explain_batch(
            model_, torch.as_tensor(imgs, device=dev, dtype=dtype),
            torch.as_tensor(idx, device=dev), ops=K.PLAIN_OPS,
            with_diagnostics=True, **prod)[1]
            for imgs, idx in batches]).double()

    d_ref = plain_diag(model64, torch.float64)
    d_p32 = plain_diag(ex_prod.model, torch.float32)
    finite = torch.isfinite(torch.cat(heats_diag)).all(dim=1)
    require(bool(torch.isfinite(d_k[finite]).all()),
            "production diagnostics: a field is not finite on a sample "
            "whose heatmap is")
    print(f"production diagnostics bitwise-neutral on {len(batches)} "
          f"batches; per field over {len(d_k)} samples, relative error "
          f"against the plain f64 path's, max / median, of the kernel path "
          f"and of the plain f32 path (not gated), and sample 0's values:")
    for f, name in enumerate(DIAG_FIELDS):
        rel_k, rel_p = ((d[:, f] - d_ref[:, f]).abs()
                        / d_ref[:, f].abs().clamp(min=1e-30)
                        for d in (d_k, d_p32))
        print(f"  diag {name:9s} kernel {rel_k.max().item():.3e} / "
              f"{rel_k.median().item():.3e}, plain f32 "
              f"{rel_p.max().item():.3e} / {rel_p.median().item():.3e}; "
              f"sample 0: kernel {d_k[0, f].item():.6e}, plain f64 "
              f"{d_ref[0, f].item():.6e}")
    del diags, d_k, d_ref, d_p32

    # the split MLP precisions: production with the forward's MLP products
    # (B2's fc1_pre / fc2_pre anchors) in bf16 and the reverse's (B3's MLP
    # gradient products) in bf16x3, under production's gates against its
    # own plain float64 path
    mlp_split_kw = dict(prod, mlp_fwd_precision="bfloat16",
                        mlp_bwd_precision="tensorfloat32")
    ex_mlp = Explainer(params, cfg, device="cuda", **mlp_split_kw)
    heats_mlp, launches_mlp = drive(ex_mlp.explain, batches, vit_shape,
                                    per_prod, "production mlp split")
    gate("production mlp split (fwd bfloat16, bwd tensorfloat32)",
         *preset_corrs(ex_mlp.model, model64, heats_mlp, mlp_split_kw)[:2],
         "median")
    c_ms = np.asarray(sum((corr(a, b_.double()) for a, b_ in zip(
        heats_mlp, heats_prod)), []))
    print(f"production mlp split corr vs production, not gated: min "
          f"{c_ms.min():.6f} median {np.median(c_ms):.6f}")
    del ex_mlp, heats_mlp

    # every ViT method in exact FP32 on the first batch, plus the lrp
    # variant and alpha = 2 of transformer_attribution: the kernel branch
    # for the fused method (ours, alpha 1), the non-kernel branch with the
    # rollout kernel for the others; per-sample corr >= MIN_CORR against
    # the plain float64 run of the same method, except on a sample where
    # the plain float32 run falls below MIN_CORR too (exact FP32 is
    # ill-conditioned there for this method and these random weights):
    # there no lower than the plain float32 run's corr - PROD_MIN_SLACK
    ex_lrp = Explainer(params, cfg, device="cuda", variant="lrp")
    grid = (8, cfg.grid, cfg.grid)
    explainers = {"ours": ex, "lrp": ex_lrp}
    method_runs = [(m, "ours", {}) for m in METHODS] + [
        ("transformer_attribution", "lrp", {}),
        ("transformer_attribution", "ours", dict(alpha=2.0))]
    method_launches = []
    imgs0, idx0 = batches[0]
    img64 = torch.as_tensor(imgs0, device=dev, dtype=torch.float64)
    idx0_t = torch.as_tensor(idx0, device=dev)
    for m, variant, kw in method_runs:
        label = f"method {m} variant {variant} {kw}"
        explainer = explainers[variant]
        kernel = uses_kernel_branch(m, kw.get("alpha", 1.0), variant)
        per = {**none}
        if kernel:
            per.update(attn_fwd_core=L, attn_rev_core=L)
        if m in ROLLOUT_METHODS:
            per["rollout_from_grad_cam"] = 1
        shape = {"full": (8, cfg.img_size, cfg.img_size),
                 "attn_gradcam": grid}.get(m, vit_shape)
        (heat,), counts = drive(
            lambda im, ix: explainer.explain(im, ix, method=m, **kw),
            [batches[0]], shape, per, label, finite=m != "attn_gradcam")
        method_launches.append(counts)
        ref = explain_batch(model64, img64, idx0_t, method=m,
                            variant=variant, ops=K.PLAIN_OPS, **kw)
        plain32 = explain_batch(ex.model, img64.float(), idx0_t, method=m,
                                variant=variant, ops=K.PLAIN_OPS, **kw)
        # attn_gradcam min-max normalises a relu'd map: where the map has
        # no positive entry the method's answer is 0/0 (NaN, in JAX and the
        # reference too). Those samples must be the float64 run's, and the
        # others finite and gated
        heat, ref = heat.reshape(8, -1), ref.reshape(8, -1)
        plain32 = plain32.reshape(8, -1)
        ok = torch.isfinite(ref).all(dim=1)
        ok_k = torch.isfinite(heat).all(dim=1)
        require(torch.equal(ok_k, ok) and bool(ok.any()),
                f"{label}: finite samples {ok_k.tolist()}, float64 run's "
                f"{ok.tolist()}")
        c = np.asarray(corr(heat[ok], ref[ok]))
        c_p = np.asarray(corr(plain32[ok], ref[ok]))
        floor = np.where(c_p >= MIN_CORR, MIN_CORR, c_p - PROD_MIN_SLACK)
        print(f"{label} corr vs plain f64 on the card over {len(c)} samples "
              f"(0/0 in {int((~ok).sum())}): min {c.min():.6f} median "
              f"{np.median(c):.6f} (plain f32 run: min {c_p.min():.6f}); per "
              f"sample {fmt(c)}, plain f32 run {fmt(c_p)}")
        require((c >= floor).all(), f"{label}: per-sample corr {fmt(c)} "
                f"below {fmt(floor)}")
    del model64, ex_lrp, explainers, img64
    torch.cuda.empty_cache()

    # ViT-L/16 (24 blocks, D=1024, h=16, M=4096) and DeiT-base distilled
    # (n = 198), random weights from the seeded init_params, on the same
    # three batches: exact FP32 (B4, B5, B1) and production (B2, B3, B1)
    # for both, and rollout_attn (the non-kernel branch and B1) for DeiT;
    # each gated against the port's plain path of the same arguments in
    # float64 on the card, as ViT-B's presets and methods are; the plain
    # float32 path's corr is the lower of two float32 draws, on the weights
    # as they are and moved one float32 ulp. At 24 blocks exact FP32 is
    # ill-conditioned for any float32 implementation on these random
    # weights: on an H100 the plain float32 path reached corr -0.035, 0.754
    # and 0.393 on three of ViT-L's 24 samples, and over eight draws of the
    # weights moved one float32 ulp both paths scattered, each on samples
    # of its own (the plain path to -0.239 on one where its unmoved draw
    # gives 0.99997, the kernel path to 0.965 on another;
    # experiments/torch_vit_conditioning.py --draws 8). So ViT-L's float32
    # run is gated as production is (the median, and the min against the
    # plain path's); DeiT's float32 runs keep the per-sample rule
    new_cfgs = {"ViT-L/16": (VIT_LARGE_16_224, "median"),
                "DeiT-B distilled": (DEIT_BASE_DISTILLED_16_224,
                                     "per-sample")}
    new_explainers, new_heats, new_launches = {}, {}, []
    deit_ref = None
    for mname, (mcfg, f32_gate) in new_cfgs.items():
        mparams = init_params(mcfg, generator=torch.Generator(device=dev)
                              .manual_seed(0), device=dev)
        m64 = VisionTransformer(mcfg, device=dev, dtype=torch.float64)
        m64.load_state_dict({k: v.double() for k, v in mparams.items()})
        m64.requires_grad_(False)
        m32u = VisionTransformer(mcfg, device=dev)
        m32u.load_state_dict(ulp_moved(mparams, 98))
        m32u.requires_grad_(False)
        Lm = mcfg.depth
        runs = [("float32", {}, dict(attn_fwd_core=Lm, attn_rev_core=Lm),
                 f32_gate),
                ("production", prod, dict(block_fwd_core=Lm,
                                          block_rev_core=Lm), "median")]
        if mcfg.distilled:
            runs.append(("rollout_attn", dict(method="rollout_attn"), {},
                         "per-sample"))
        for label, kw, per, kind in runs:
            exm = Explainer(mparams, mcfg, device="cuda",
                            **{k: v for k, v in kw.items() if k != "method"})
            call = (exm.explain if "method" not in kw else
                    lambda im, ix, exm=exm: exm.explain(im, ix,
                                                        method=kw["method"]))
            hs, counts = drive(call, batches, vit_shape,
                               {**none, **per, "rollout_from_grad_cam": 1},
                               f"{mname} {label}")
            new_launches.append(counts)
            c, c_plain, c_moved = preset_corrs(
                exm.model, m64, hs, kw, m32u if kw is not prod else None)
            gate(f"{mname} {label}", c, c_plain, kind, c_moved)
            new_explainers[(mname, label)] = exm
            new_heats[(mname, label)] = hs
        if mcfg.distilled:
            deit_ref = (mparams, m64, m32u)
        del mparams, m64, m32u
        torch.cuda.empty_cache()

    # BERT-base, both presets: three batches of 8 at S=512, each sample
    # padded to its own length, two argmax indices per batch
    bparams = bert_mod.init_params(bcfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    rng = np.random.RandomState(7)
    bert_batches = []
    for k in range(3):
        lengths = rng.randint(64, 513, size=8)
        lengths[0] = 512
        valid = np.arange(512)[None, :] < lengths[:, None]
        ids = np.where(valid, rng.randint(1000, bcfg.vocab_size,
                                          size=(8, 512)), 0)
        ids[:, 0] = 101                                  # [CLS]
        idx = rng.randint(0, bcfg.num_labels, size=8)
        idx[[1, 5]] = -1
        bert_batches.append((ids, valid.astype(np.float32), idx))
    bex = BertExplainer(bparams, bcfg, device="cuda")
    bex_prod = BertExplainer(bparams, bcfg, device="cuda", **prod)
    BL = bcfg.num_layers
    bert_shape = (8, 512)
    bheats, blaunches = drive(bex.explain, bert_batches, bert_shape,
                              {**none, "rollout_from_grad_cam": 1},
                              "bert float32")
    bheats_prod, blaunches_prod = drive(
        bex_prod.explain, bert_batches, bert_shape,
        {**none, "bert_layer_fwd_core": BL, "bert_out_rev_core": BL,
         "bert_attn_rev_core": BL, "rollout_from_grad_cam": 1},
        "bert production")

    def token_corr(x, y, valid):
        """Per-sample Pearson corr over each sample's tokens."""
        out = []
        for a, b, v in zip(x.double(), y.double(), valid):
            a, b = a[v], b[v]
            a, b = a - a.mean(), b - b.mean()
            out.append(((a * b).sum() / (a.norm() * b.norm())).item())
        return out

    bmodel64 = bert_mod.BertForSequenceClassification(bcfg, device=dev,
                                                      dtype=torch.float64)
    bmodel64.load_state_dict({k: v.double() if v.is_floating_point() else v
                              for k, v in bparams.items()})
    bmodel64.requires_grad_(False)
    bc, bc_plain, bpc, bpc_plain, bp_exact = [], [], [], [], []
    for (ids, valid, idx), heat, heat_p in zip(bert_batches, bheats,
                                               bheats_prod):
        ids_t = torch.as_tensor(ids, device=dev)
        m_t = torch.as_tensor(valid, device=dev)
        idx_t = torch.as_tensor(idx, device=dev)
        v_t = m_t.bool()
        ref = bg.explain_batch(bmodel64, ids_t, m_t, idx_t,
                               ops=K.BERT_PLAIN_OPS)
        plain32 = bg.explain_batch(bex.model, ids_t, m_t, idx_t,
                                   ops=K.BERT_PLAIN_OPS)
        bc += token_corr(heat, ref, v_t)
        bc_plain += token_corr(plain32, ref, v_t)
        ref_p = bg.explain_batch(bmodel64, ids_t, m_t, idx_t,
                                 ops=K.BERT_PLAIN_OPS, **prod)
        plain32_p = bg.explain_batch(bex_prod.model, ids_t, m_t, idx_t,
                                     ops=K.BERT_PLAIN_OPS, **prod)
        bpc += token_corr(heat_p, ref_p, v_t)
        bpc_plain += token_corr(plain32_p, ref_p, v_t)
        bp_exact += token_corr(heat_p, ref, v_t)
    bc, bc_plain = np.asarray(bc), np.asarray(bc_plain)
    bpc, bpc_plain, bp_exact = (np.asarray(a) for a in (bpc, bpc_plain,
                                                        bp_exact))
    print(f"bert float32 slice corr vs plain f64 on the card: min "
          f"{bc.min():.6f} median {np.median(bc):.6f} over {len(bc)} samples "
          f"(plain f32 path: min {bc_plain.min():.6f} median "
          f"{np.median(bc_plain):.6f}); per sample {fmt(bc)}")
    require(bc.min() >= MIN_CORR, f"bert float32 per-sample corr "
            f"{bc.min():.6f} below {MIN_CORR}")
    print(f"bert production slice corr vs plain production f64 on the card: "
          f"min {bpc.min():.6f} median {np.median(bpc):.6f} (plain f32 "
          f"production path: min {bpc_plain.min():.6f} median "
          f"{np.median(bpc_plain):.6f}); per sample {fmt(bpc)}")
    print(f"bert production slice corr vs exact f64 (float32 preset, plain) "
          f"on the card, not gated: min {bp_exact.min():.6f} median "
          f"{np.median(bp_exact):.6f} mean {bp_exact.mean():.6f}; per sample "
          f"{fmt(bp_exact)}")
    require(np.median(bpc) >= MIN_CORR,
            f"bert production median corr {np.median(bpc):.6f} below "
            f"{MIN_CORR}")
    # BERT production's answer is ill-conditioned on a few random-weight
    # samples for any float32 implementation: one bf16 rounding that falls
    # the other way (float32 vs float64 operands) moves a near-zero add-rule
    # denominator, and the sample's map with it. The kernel and the plain
    # float32 path each land on such samples, different ones, so their
    # minima are two draws (PERF.md §6, PR 3). The tail is gated by count:
    # no more samples below TAIL_CORR than the plain float32 path + 1.
    k_tail = int((bpc < TAIL_CORR).sum())
    p_tail = int((bpc_plain < TAIL_CORR).sum())
    print(f"bert production samples below {TAIL_CORR}: kernel path {k_tail}, "
          f"plain f32 path {p_tail}; min {bpc.min():.6f} vs the plain f32 "
          f"path's {bpc_plain.min():.6f} (not gated)")
    require(k_tail <= p_tail + 1,
            f"bert production: {k_tail} samples below {TAIL_CORR}, the plain "
            f"f32 path {p_tail}")

    # each BERT method in exact FP32 on the first batch, plus the lrp
    # variant and alpha = 2 of transformer_attribution (rollout from start
    # layer 0, as generate_rollout calls it): the plain layers, with the
    # rollout kernel for transformer_attribution (the head means) and for
    # rollout (the per-head probabilities, through its head-mean pass, in
    # the same wrapper call); per-sample corr over the sample's tokens
    # against the plain float64 run of the same method, gated as the ViT
    # methods are
    bex_lrp = BertExplainer(bparams, bcfg, device="cuda", variant="lrp")
    bexplainers = {"ours": bex, "lrp": bex_lrp}
    bert_method_runs = [(m, "ours", dict(start_layer=0) if m == "rollout"
                         else {}) for m in bg.METHODS] + [
        ("transformer_attribution", "lrp", {}),
        ("transformer_attribution", "ours", dict(alpha=2.0))]
    bert_method_launches = []
    ids0_t, m0_t, bidx0_t = (torch.as_tensor(a, device=dev)
                             for a in bert_batches[0])
    for m, variant, kw in bert_method_runs:
        label = f"bert method {m} variant {variant} {kw}"
        explainer = bexplainers[variant]
        per = {**none}
        if m in BERT_ROLLOUT_METHODS:
            per["rollout_from_grad_cam"] = 1
        (heat,), counts = drive(
            lambda i, v, x: explainer.explain(i, v, x, method=m, **kw),
            [bert_batches[0]], bert_shape, per, label,
            finite=m != "attn_gradcam")
        bert_method_launches.append(counts)
        ref = bg.explain_batch(bmodel64, ids0_t, m0_t, bidx0_t, method=m,
                               variant=variant, ops=K.BERT_PLAIN_OPS, **kw)
        plain32 = bg.explain_batch(bex.model, ids0_t, m0_t, bidx0_t,
                                   method=m, variant=variant,
                                   ops=K.BERT_PLAIN_OPS, **kw)
        # attn_gradcam is 0/0 on a map with no positive entry (as in JAX):
        # those samples must be the float64 run's, the others are gated
        ok = torch.isfinite(ref).all(dim=1)
        ok_k = torch.isfinite(heat).all(dim=1)
        require(torch.equal(ok_k, ok) and bool(ok.any()),
                f"{label}: finite samples {ok_k.tolist()}, float64 run's "
                f"{ok.tolist()}")
        v_ok = m0_t.bool()[ok]
        c = np.asarray(token_corr(heat[ok], ref[ok], v_ok))
        c_p = np.asarray(token_corr(plain32[ok], ref[ok], v_ok))
        floor = np.where(c_p >= MIN_CORR, MIN_CORR, c_p - PROD_MIN_SLACK)
        print(f"{label} corr vs plain f64 on the card over {len(c)} samples "
              f"(0/0 in {int((~ok).sum())}): min {c.min():.6f} median "
              f"{np.median(c):.6f} (plain f32 run: min {c_p.min():.6f}); per "
              f"sample {fmt(c)}, plain f32 run {fmt(c_p)}")
        require((c >= floor).all(), f"{label}: per-sample corr {fmt(c)} "
                f"below {fmt(floor)}")
    del bmodel64, bex_lrp, bexplainers, ref, plain32
    torch.cuda.empty_cache()

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")
    # the tensor-parallel ViT program at k = 1 over a single-rank NCCL group
    # (its all-reduces run, trivially), explaining the same batches with
    # the same weights, sharded once per preset
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    params64 = {k: v.double() for k, v in params.items()}
    tp, tp_launches = {}, []
    single = {"float32": heats, "production": heats_prod}
    for label, kw in (("float32", {}), ("production", prod)):
        mode = prec.mxu_name(kw.get("matmul_precision"))
        sh32 = shard_tp_params(params, cfg, mode=mode)
        sh64 = shard_tp_params(params64, cfg, mode=mode)
        fn = make_tp_explain_fn(cfg, device="cuda", pre_sharded=True, **kw)
        plain_fn = make_tp_explain_fn(cfg, device="cuda", pre_sharded=True,
                                      ops=K.PLAIN_OPS, **kw)
        per = {**none, "attn_fwd_core": L, "attn_rev_core": L,
               "rollout_from_grad_cam": 1}
        if label == "production":
            per.update(mlp_rev_tp_phase1=L, mlp_rev_tp_phase2=L)
        heats_tp, counts = drive(lambda im, ix: fn(sh32, im, ix), batches,
                                 vit_shape, per, f"tp {label}")
        tp_launches.append(counts)
        c_k, c_p, c_single = [], [], []
        for (imgs, idx), heat, heat_1 in zip(batches, heats_tp,
                                             single[label]):
            ref = plain_fn(sh64, imgs, idx)
            c_k += corr(heat, ref)
            c_p += corr(plain_fn(sh32, imgs, idx), ref)
            c_single += corr(heat, heat_1.double())
        c_k, c_p, c_single = map(np.asarray, (c_k, c_p, c_single))
        print(f"tp {label} slice corr vs plain tp {label} f64 on the card: "
              f"min {c_k.min():.6f} median {np.median(c_k):.6f} (plain f32 "
              f"tp path: min {c_p.min():.6f} median {np.median(c_p):.6f}); "
              f"per sample {fmt(c_k)}")
        print(f"tp {label} slice corr vs the single-device {label} kernel "
              f"path, not gated: min {c_single.min():.6f} median "
              f"{np.median(c_single):.6f}; per sample {fmt(c_single)}")
        if label == "float32":
            require(c_k.min() >= MIN_CORR, f"tp float32 per-sample corr "
                    f"{c_k.min():.6f} below {MIN_CORR}")
        else:
            require(np.median(c_k) >= MIN_CORR, f"tp production median corr"
                    f" {np.median(c_k):.6f} below {MIN_CORR}")
            require(c_k.min() >= c_p.min() - PROD_MIN_SLACK,
                    f"tp production min corr {c_k.min():.6f} below the plain "
                    f"f32 tp path's {c_p.min():.6f} - {PROD_MIN_SLACK}")
        tp[label] = (fn, plain_fn, sh32)
        del sh64
    del params64
    # the tensor-parallel program on DeiT-base distilled at k = 1 in exact
    # FP32: it explains the fused logits (head(cls) + head_dist(dist)) / 2
    # as the single-device path does, so it is gated against the
    # single-device plain float64 path by the per-sample rule (the plain
    # float32 TP program's two draws); its corr against the single-device
    # float32 kernel path is printed
    deit = DEIT_BASE_DISTILLED_16_224
    dparams, d64, d32u = deit_ref
    sh_d = shard_tp_params(dparams, deit, mode="float32")
    sh_du = shard_tp_params(d32u.state_dict(), deit, mode="float32")
    fn_d = make_tp_explain_fn(deit, device="cuda", pre_sharded=True)
    plain_d = make_tp_explain_fn(deit, device="cuda", pre_sharded=True,
                                 ops=K.PLAIN_OPS)
    heats_dtp, counts = drive(
        lambda im, ix: fn_d(sh_d, im, ix), batches, vit_shape,
        {**none, "attn_fwd_core": deit.depth, "attn_rev_core": deit.depth,
         "rollout_from_grad_cam": 1}, "tp DeiT-B distilled float32")
    tp_launches.append(counts)
    c_k, c_p, c_pu, c_single = [], [], [], []
    for (imgs, idx), heat, heat_1 in zip(
            batches, heats_dtp, new_heats[("DeiT-B distilled", "float32")]):
        idx_t = torch.as_tensor(idx, device=dev)
        ref = explain_batch(d64, torch.as_tensor(
            imgs, device=dev, dtype=torch.float64), idx_t, ops=K.PLAIN_OPS)
        c_k += corr(heat, ref)
        c_p += corr(plain_d(sh_d, imgs, idx), ref)
        c_pu += corr(plain_d(sh_du, imgs, idx), ref)
        c_single += corr(heat, heat_1.double())
    c_single = np.asarray(c_single)
    gate("tp DeiT-B distilled float32 (vs the single-device plain f64 "
         "path)", np.asarray(c_k), np.asarray(c_p), "per-sample",
         np.asarray(c_pu))
    print(f"tp DeiT-B distilled float32 corr vs the single-device float32 "
          f"kernel path, not gated: min {c_single.min():.6f} median "
          f"{np.median(c_single):.6f}; per sample {fmt(c_single)}")
    deit_prod0 = new_heats[("DeiT-B distilled", "production")][0]
    del deit_ref, d64, d32u, sh_d, sh_du, fn_d, plain_d, heats_dtp
    del new_heats
    torch.cuda.empty_cache()

    # checkpoints: the seeded parameters written as the files a user holds
    # (under build/, git-ignored), loaded by create_model on the card and
    # explained in production on the first batch; the maps must be bitwise
    # those of the same parameters passed to the explainer directly (the
    # runs above). ViT-B/16 as a flat timm .pth, DeiT-B distilled with the
    # state dict under "model" (DeiT's hub files), ViT-B/16 as the port's
    # .npz (save_vit_npz), BERT-base as pytorch_model.bin (bert. prefix and
    # classifier) at S=512 with the padded masks above, and as
    # model.safetensors where the card's machine has safetensors
    from transformer_explainability_torch import create_model
    from transformer_explainability_torch.params.convert import save_vit_npz
    ck_dir = os.path.join(ROOT, "build", "checkpoints")
    os.makedirs(ck_dir, exist_ok=True)

    def on_cpu(sd):
        return {k: v.detach().cpu().contiguous() for k, v in sd.items()}

    def bitwise(a, b):
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))

    vit_per = {**none, "block_fwd_core": L, "block_rev_core": L,
               "rollout_from_grad_cam": 1}
    bert_per = {**none, "bert_layer_fwd_core": BL, "bert_out_rev_core": BL,
                "bert_attn_rev_core": BL, "rollout_from_grad_cam": 1}
    ckpt_cases = [
        ("vit_base_patch16_224", "flat .pth", "vit_base.pth",
         lambda path: torch.save(on_cpu(params), path), heats_prod[0]),
        ("deit_base_distilled_patch16_224", ".pth, state dict under 'model'",
         "deit_distilled.pth",
         lambda path: torch.save({"model": on_cpu(dparams)}, path),
         deit_prod0),
        ("vit_base_patch16_224", ".npz (save_vit_npz)", "vit_base.npz",
         lambda path: save_vit_npz(path, params), heats_prod[0])]
    bert_dir = os.path.join(ck_dir, "bert-base-uncased")
    os.makedirs(bert_dir, exist_ok=True)
    ckpt_cases.append(
        ("bert-base-uncased", "pytorch_model.bin (bert. prefix, classifier)",
         os.path.join("bert-base-uncased", "pytorch_model.bin"),
         lambda path: torch.save(on_cpu(bparams), path), bheats_prod[0]))
    if have["safetensors"]:
        from safetensors.torch import save_file
        os.makedirs(os.path.join(ck_dir, "bert-st"), exist_ok=True)
        ckpt_cases.append(
            ("bert-base-uncased", "model.safetensors",
             os.path.join("bert-st", "model.safetensors"),
             lambda path: save_file(on_cpu(bparams), path), bheats_prod[0]))
    ckpt_launches = []
    for name, form, fname, write, want in ckpt_cases:
        path = os.path.join(ck_dir, fname)
        write(path)
        is_bert = name.startswith("bert")
        ccfg, csd = create_model(
            name, checkpoint=os.path.dirname(path) if is_bert else path,
            device="cuda")
        require(all(v.is_cuda for v in csd.values()),
                f"checkpoint {name} {form}: state dict not on the card")
        if is_bert:
            exc = BertExplainer(csd, ccfg, device="cuda", **prod)
            (heat,), counts = drive(exc.explain, [bert_batches[0]],
                                    bert_shape, bert_per,
                                    f"checkpoint {name} {form}")
        else:
            exc = Explainer(csd, ccfg, device="cuda", **prod)
            (heat,), counts = drive(exc.explain, [batches[0]], vit_shape,
                                    vit_per, f"checkpoint {name} {form}")
        ckpt_launches.append(counts)
        same = bitwise(heat, want)
        print(f"checkpoint {name} {form}: loaded by create_model, production"
              f" maps bitwise those of the parameters passed directly: "
              f"{same}")
        require(same, f"checkpoint {name} {form}: maps differ from the "
                f"direct parameters' (max |d| "
                f"{(heat - want).abs().max().item():.3e})")
        del exc, csd
    del dparams
    torch.cuda.empty_cache()

    # ViT-B/16 at 384 px (n = 577): timm's vit_base_patch16_384 geometry,
    # reached as the JAX package reaches it, the seeded 224-px weights
    # through adapt_pretrained (the position table resized 14 -> 24 on the
    # card); fidelity_truth's 17 images resized to 384 by utils.image on
    # the card and 7 seeded noise images, three batches of 8. float32 and
    # production, each per-sample corr against the port's plain float64
    # path of the same preset: production by production's gates (median
    # >= MIN_CORR, min no lower than the plain float32 path's -
    # PROD_MIN_SLACK), float32 by the per-sample rule that DeiT's and the
    # methods' exact FP32 runs take (>= MIN_CORR where the plain float32
    # path reaches it, else no lower than its corr - PROD_MIN_SLACK, its
    # corr the lower of two float32 draws): at 384 px exact FP32 is
    # ill-conditioned on one of these samples for any float32
    # implementation (on an H100 the kernel path 0.807550, the plain
    # float32 path 0.810284, every other sample >= 0.999183)
    from transformer_explainability_torch.params.convert import (
        adapt_pretrained)
    from transformer_explainability_torch.utils.image import (
        resize_bilinear_chw)
    cfg384 = dataclasses.replace(cfg, img_size=384)
    p384 = adapt_pretrained(params, cfg384)
    require(tuple(p384["pos_embed"].shape) == (1, 577, cfg.embed_dim),
            f"adapt_pretrained: pos_embed {tuple(p384['pos_embed'].shape)}")
    imgs384 = torch.cat([
        resize_bilinear_chw(torch.as_tensor(imgs_all, device=dev), 384, 384),
        torch.randn(24 - len(imgs_all), 3, 384, 384, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(384))])
    idx384 = np.concatenate([idx_all, np.full(24 - len(idx_all), -1)])
    batches384 = []
    for k in range(3):
        idx = idx384[8 * k:8 * k + 8].copy()
        idx[[1, 5]] = -1
        batches384.append((imgs384[8 * k:8 * k + 8].contiguous(), idx))
    m64_384 = VisionTransformer(cfg384, device=dev, dtype=torch.float64)
    m64_384.load_state_dict({k: v.double() for k, v in p384.items()})
    m64_384.requires_grad_(False)
    m32u_384 = VisionTransformer(cfg384, device=dev)
    m32u_384.load_state_dict(ulp_moved(p384, 384))
    m32u_384.requires_grad_(False)
    shape384 = (8, cfg384.num_patches)
    launches384, models384 = [], {}
    for label, kw, per in (
            ("float32", {}, dict(attn_fwd_core=L, attn_rev_core=L)),
            ("production", prod, dict(block_fwd_core=L, block_rev_core=L))):
        ex384 = Explainer(p384, cfg384, device="cuda", **kw)
        hs, counts = drive(ex384.explain, batches384, shape384,
                           {**none, **per, "rollout_from_grad_cam": 1},
                           f"ViT-B/16 384px {label}")
        launches384.append(counts)
        c, c_plain, c_moved = [], [], []
        for (imgs, idx), heat in zip(batches384, hs):
            idx_t = torch.as_tensor(idx, device=dev)
            ref = explain_batch(m64_384, imgs.double(), idx_t,
                                ops=K.PLAIN_OPS, **kw)
            c += corr(heat, ref)
            c_plain += corr(explain_batch(ex384.model, imgs, idx_t,
                                          ops=K.PLAIN_OPS, **kw), ref)
            if not kw:
                c_moved += corr(explain_batch(m32u_384, imgs, idx_t,
                                              ops=K.PLAIN_OPS), ref)
        gate(f"ViT-B/16 384px {label}", np.asarray(c), np.asarray(c_plain),
             "median" if kw else "per-sample",
             np.asarray(c_moved) if c_moved else None)
        models384[label] = ex384.model          # timed in phase 5
        del ex384, hs
    imgs384_t = batches384[0][0]
    del m64_384, m32u_384, p384, imgs384, batches384
    torch.cuda.empty_cache()

    # the harnesses at ViT-B/16's full width, on an in-memory dataset of 32
    # (image, label) pairs at 224 px: fidelity_truth's 17 images and 15
    # seeded smooth ones, each label a seeded binary mask of smooth blobs
    from transformer_explainability_torch.eval.perturbation import (
        PERTURB_STEPS, run_perturbation_eval)
    from transformer_explainability_torch.eval.seg import (SEG_METHODS,
                                                           run_seg_eval)
    from transformer_explainability_torch.eval.visualize import (
        compute_saliency_and_save, saliency_maps)
    hr = np.random.RandomState(15)
    smooth = lambda a: torch.nn.functional.interpolate(
        torch.from_numpy(a), size=(224, 224), mode="bilinear",
        align_corners=False).numpy()
    seg_imgs = np.concatenate([imgs_all, smooth(
        hr.randn(32 - len(imgs_all), 3, 28, 28).astype(np.float32))])
    seg_lbls = (smooth(hr.randn(32, 1, 7, 7).astype(np.float32))[:, 0]
                > 0.3).astype(np.int64)
    seg_ds = list(zip(seg_imgs, seg_lbls))
    params64 = {k: v.double() for k, v in params.items()}
    print(f"harness gates (fixed before the first chip run): seg metrics "
          f"|kernel - plain f64| <= {SEG_GATES} (or the plain f32 path's "
          f"|d| + that, where its |d| exceeds it); perturbation step accuracy "
          f"|d| <= {PERT_STEP_GATE:.4f} at every step, AUC |d| <= "
          f"{PERT_AUC_GATE:.2f}")

    def plain_seg_fn(method, preset, bits=64):
        em, variant, sl = SEG_METHODS[method]
        kw = precision_kwargs(preset)
        dtype = torch.float64 if bits == 64 else torch.float32

        def fn(model, imgs, idx):
            return explain_batch(model, torch.as_tensor(
                imgs, device=dev, dtype=dtype), idx.to(dev), sl, em,
                ops=K.PLAIN_OPS, variant=variant, **kw)
        return fn

    def seg_per(method, preset, nb):
        if method == "transformer_attribution":
            fused = (dict(attn_fwd_core=L, attn_rev_core=L)
                     if preset == "float32" else
                     dict(block_fwd_core=L, block_rev_core=L))
            return {**none, **{k: nb * v for k, v in fused.items()},
                    "rollout_from_grad_cam": nb}
        if method == "rollout":                # rollout_attn: B1
            return {**none, "rollout_from_grad_cam": nb}
        return dict(none)                      # plain layers only

    seg_runs = [("transformer_attribution", "float32"),
                ("transformer_attribution", "production")] + [
        (m, "float32") for m in ("rollout", "full_lrp", "lrp_last_layer",
                                 "attn_last_layer", "attn_gradcam")]
    harness_launches = []
    n_seg = len(seg_ds)
    for method, preset in seg_runs:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_seg_eval(seg_ds, params, cfg, method, batch_size=8,
                           progress=False, precision=preset, device="cuda")
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        require(counts == seg_per(method, preset, n_seg // 8),
                f"seg {method} {preset}: launches {counts}")
        harness_launches.append(counts)
        ref = run_seg_eval(seg_ds, params64, cfg, method, batch_size=8,
                           progress=False, precision=preset, device="cuda",
                           explain_fn=plain_seg_fn(method, preset))
        p32 = run_seg_eval(seg_ds, params, cfg, method, batch_size=8,
                           progress=False, precision=preset, device="cuda",
                           explain_fn=plain_seg_fn(method, preset, 32))
        d = {k: abs(res[k] - ref[k]) for k in res}
        dp = {k: abs(p32[k] - ref[k]) for k in res}
        lim = {k: SEG_GATES[preset] + (dp[k] if dp[k] > SEG_GATES[preset]
                                       else 0.0) for k in res}
        print(f"seg {method} {preset}: kernels {res}; plain f64 {ref}; "
              f"|d| {d} <= {lim} (plain f32 path's |d| {dp}); "
              f"{n_seg / dt:.1f} images/s (harness wall, metrics included) "
              f"{tag}")
        require(all(np.isfinite(list(r.values())).all()
                    for r in (res, ref, p32)),
                f"seg {method} {preset}: NaN metric")
        require(all(d[k] <= lim[k] for k in d),
                f"seg {method} {preset}: metrics differ by {d}")

    # the perturbation harness, positive and negative, on the
    # transformer_attribution maps of the kernel path (visualize's
    # saliency_maps: upsampled and min-max normalised per image on the
    # card) of the 32 images in [0, 1], each target the float32 model's
    # own class; its ten forwards a batch in exact FP32 on the kernels
    # against the plain float64 forwards on the same maps
    imgs01 = (seg_imgs * 0.5 + 0.5).astype(np.float32)
    with torch.no_grad():
        targets = ex.model(torch.as_tensor(seg_imgs, device=dev)).argmax(
            1).cpu().numpy()
    K.reset_launch_counts()
    vis = torch.cat([saliency_maps(ex, imgs01[s:s + 8], targets[s:s + 8],
                                   "transformer_attribution")
                     for s in range(0, 32, 8)]).cpu().numpy()
    counts = K.launch_counts()
    require(counts == seg_per("transformer_attribution", "float32", 4),
            f"saliency_maps: launches {counts}")
    harness_launches.append(counts)
    require(np.isfinite(vis).all() and vis.min() == 0 and vis.max() == 1,
            "saliency maps: not finite min-max normalised maps")

    class MemResults:
        """results.hdf5's reader, in memory (needs no h5py)."""

        def __len__(self):
            return len(imgs01)

        def batches(self, batch_size):
            for s in range(0, len(imgs01), batch_size):
                yield (imgs01[s:s + batch_size], vis[s:s + batch_size],
                       targets[s:s + batch_size])

    pert_res = {}
    for neg in (False, True):
        label = "negative" if neg else "positive"
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = run_perturbation_eval(MemResults(), params, cfg, neg=neg,
                                  batch_size=8, progress=False,
                                  device="cuda")
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        nf = 4 * (1 + len(PERTURB_STEPS))      # forwards: 4 batches of 10
        require(counts == {**none, "attn_fwd_core": nf * L},
                f"perturbation {label}: launches {counts}")
        harness_launches.append(counts)
        r64 = run_perturbation_eval(MemResults(), params64, cfg, neg=neg,
                                    batch_size=8, progress=False,
                                    device="cuda", ops=K.PLAIN_OPS)
        dstep = np.abs(r["step_accuracy"] - r64["step_accuracy"]).max()
        dauc = abs(r["auc"] - r64["auc"])
        print(f"perturbation {label}: step accuracy {fmt(r['step_accuracy'])}"
              f" AUC {r['auc']:.4f}; plain f64 {fmt(r64['step_accuracy'])} "
              f"AUC {r64['auc']:.4f}; base hits {r['model_hits'].mean():.4f}"
              f" (plain f64 {r64['model_hits'].mean():.4f}); max step |d| "
              f"{dstep:.4f} <= {PERT_STEP_GATE:.4f}, AUC |d| {dauc:.4f} <= "
              f"{PERT_AUC_GATE:.2f}; {len(imgs01) / dt:.1f} images/s "
              f"(10 forwards each, harness wall) {tag}")
        require(all(np.isfinite(r[k]).all() for k in r),
                f"perturbation {label}: non-finite result")
        require(dstep <= PERT_STEP_GATE and dauc <= PERT_AUC_GATE,
                f"perturbation {label}: curve or AUC outside the gates")
        pert_res[neg] = r
    if have["h5py"]:
        # the two-stage file path: compute_saliency_and_save ->
        # results.hdf5 -> ImagenetResults -> run_perturbation_eval; the
        # same maps, so the same hits as the in-memory run
        from transformer_explainability_torch.data.expl_hdf5 import (
            ImagenetResults)
        h5 = os.path.join(ck_dir, "results.hdf5")
        if os.path.exists(h5):
            os.remove(h5)
        K.reset_launch_counts()
        wrote = compute_saliency_and_save(
            ((imgs01[s:s + 8], targets[s:s + 8]) for s in range(0, 32, 8)),
            params, h5, cfg, vis_class="target", device="cuda")
        r = run_perturbation_eval(ImagenetResults(h5), params, cfg,
                                  batch_size=8, progress=False,
                                  device="cuda")
        harness_launches.append(K.launch_counts())
        same = np.array_equal(r["perturbations_hits"],
                              pert_res[False]["perturbations_hits"])
        print(f"results.hdf5: wrote {wrote}, perturbation hits equal to the "
              f"in-memory run's: {same}")
        require(wrote == 32 and same, "results.hdf5 path differs from the "
                "in-memory one")
    del params64
    torch.cuda.empty_cache()

    print(f"elapsed {time.perf_counter() - t_start:.0f} s")
    # 5. times ---------------------------------------------------------------
    times = {}
    for name, (make, kern, plain) in cases.items():
        if name == "rollout_from_grad_cam":
            continue    # timed in its forms below
        args = make(*shapes["main"], torch.float32)
        # B4 and its library yardstick take ~0.06 ms: 200 calls a window
        iters = 200 if name == "attn_fwd_core" else 20
        times[name] = (time_ms(lambda: kern(*args), iters),
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
    ti = tp_inputs
    tp_args = {"mlp_rev_tp_phase1": (*ti["a32"], *ti["w"], vit_eps,
                                     ti["mlp"], ti["rule"]),
               "mlp_rev_tp_phase2": (*ti["b32"], *ti["w"], vit_eps,
                                     ti["rule"])}
    for name, args in tp_args.items():
        times[name] = (time_ms(lambda: getattr(K, name)(*args)),
                       time_ms(lambda: getattr(K, name + "_plain")(*args)))
        print(f"time {name} {tp_shapes['main']} f32 production modes: "
              f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} "
              f"ms {tag}")
    b6 = b6_inputs
    b6_args = (*b6["a32"], b6["p32"], vit_eps, b6["mlp"], b6["rule"])
    times["mlp_rev_core"] = (time_ms(lambda: K.mlp_rev_core(*b6_args)),
                             time_ms(lambda: K.mlp_rev_core_plain(*b6_args)))
    print(f"time mlp_rev_core {tp_shapes['main']} f32 bfloat16 modes: kernel "
          f"{times['mlp_rev_core'][0]:.4f} ms, plain "
          f"{times['mlp_rev_core'][1]:.4f} ms {tag}")
    # the library yardstick of B4: one scaled_dot_product_attention call on
    # the same q, k, v (timed only; the port never calls it)
    qkv_main = cases["attn_fwd_core"][0](*shapes["main"], torch.float32)[0]
    q_, k_, v_ = bm.split_heads(qkv_main, h, hd)
    library = {name: None for name in K.launch_counts()}
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q_, k_, v_, scale=hd ** -0.5)
    library["attn_fwd_core"] = time_ms(sdpa, 200)
    print(f"time scaled_dot_product_attention {tuple(shapes['main'])} f32: "
          f"{library['attn_fwd_core']:.4f} ms {tag}")
    print(f"B4 float32 {times['attn_fwd_core'][0]:.4f} ms vs "
          f"scaled_dot_product_attention {library['attn_fwd_core']:.4f} ms: "
          f"{times['attn_fwd_core'][0] / library['attn_fwd_core']:.3f}x {tag}")
    # which kernel the library call ran (its float32 route), and the device
    # time of both calls' kernels alone (the profiler's CUDA events)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    def device_ms(fn, iters=50):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        per = {}
        for e in evs:
            per[e.key] = per.get(e.key, 0.0) + (e.self_device_time_total
                                                / iters / 1e3)
        return sum(per.values()), sorted(per), per

    b4_dev = device_ms(lambda: K.attn_fwd_core(qkv_main, h, hd, hd ** -0.5))
    sdpa_dev = device_ms(sdpa)
    print(f"scaled_dot_product_attention f32 ran: "
          f"{'; '.join(sdpa_dev[1]) or 'no kernel seen by the profiler'}")
    print(f"device time per call (profiler): B4 float32 {b4_dev[0]:.4f} ms, "
          f"scaled_dot_product_attention {sdpa_dev[0]:.4f} ms {tag}")
    # B1 at ViT-B/16 B=8, start_layer 0: the row form (rows=1, the call of
    # every path), the full form, and the per-head input (B, L, h, n, n)
    # without grads (the rollout and rollout_attn methods) and with them:
    # the whole call, and the head-mean pass's launch alone (profiler). The
    # row form's launch is shorter than its wrapper's host work, so events
    # around back-to-back calls time the host: the kernels line takes its
    # launch's device time (profiler)
    cams32 = b1_randn(B, L, n, n, dtype=torch.float32).abs() * 1e-3
    heads32 = (b1_randn(B, L, h, n, n, dtype=torch.float32) * 1e-2,
               b1_randn(B, L, h, n, n, dtype=torch.float32))
    row_dev = device_ms(lambda: K.rollout_from_grad_cam(cams32, 0, rows=1))
    require(len(row_dev[2]) == 1, f"rollout_from_grad_cam row form: "
            f"launches {sorted(row_dev[2])}")
    row_events = time_ms(lambda: K.rollout_from_grad_cam(cams32, 0, rows=1),
                         200)
    times["rollout_from_grad_cam"] = (
        row_dev[0], time_ms(lambda: K.rollout_plain(cams32, 0, rows=1)))
    roll_full = (time_ms(lambda: K.rollout_from_grad_cam(cams32, 0), 200),
                 time_ms(lambda: K.rollout_plain(cams32, 0)))
    print(f"time rollout_from_grad_cam row form (rows=1) {(B, L, n)} f32: "
          f"kernel {times['rollout_from_grad_cam'][0]:.4f} ms (profiler: "
          f"{next(iter(row_dev[2]))[:60]}), call {row_events:.4f} ms "
          f"(events), plain {times['rollout_from_grad_cam'][1]:.4f} ms "
          f"{tag}")
    print(f"time rollout_from_grad_cam full form {(B, L, n)} f32: kernel "
          f"{roll_full[0]:.4f} ms, plain {roll_full[1]:.4f} ms {tag}")
    roll_heads = {}
    for label, g32 in (("without grads", None), ("with grads", heads32[1])):
        call = lambda: K.rollout_from_grad_cam(heads32[0], 0, False, g32,
                                               rows=1)
        per = device_ms(call)[2]
        passes = [v for k, v in per.items() if "head_mean" in k]
        require(len(passes) == 1 and len(per) == 2,
                f"rollout_from_grad_cam per-head: launches {sorted(per)}")
        roll_heads[label] = (time_ms(call, 50), passes[0],
                             time_ms(lambda: K.rollout_plain(
                                 heads32[0], 0, False, g32, rows=1)))
        print(f"time rollout_from_grad_cam per-head {label} rows=1 "
              f"{(B, L, h, n)} f32: call {roll_heads[label][0]:.4f} ms "
              f"(head-mean pass {passes[0]:.4f} ms, profiler), plain "
              f"{roll_heads[label][2]:.4f} ms {tag}")
    del heads32
    # B1 on per-head maps at BERT-base's shape without grads, start layer 0
    # (the rollout method's call): the whole call and the head-mean pass's
    # launch alone (profiler); then one rollout batch under the profiler,
    # which must launch the head-mean pass and the chain once each
    bh_gen = torch.Generator(device=dev).manual_seed(13)
    bshape = (8, bcfg.num_layers, bcfg.num_heads, 512, 512)
    bprobs32 = torch.softmax(torch.randn(*bshape, generator=bh_gen, device=dev,
                                         dtype=torch.float32), dim=-1)
    bcall = lambda: K.rollout_from_grad_cam(bprobs32, 0, True, rows=1)
    per = device_ms(bcall, 20)[2]
    passes = [v for k, v in per.items() if "head_mean" in k]
    require(len(passes) == 1 and len(per) == 2,
            f"rollout_from_grad_cam per-head at BERT shape: launches "
            f"{sorted(per)}")
    roll_bert = (time_ms(bcall, 20), passes[0],
                 time_ms(lambda: K.rollout_plain(bprobs32, 0, True, rows=1)))
    print(f"time rollout_from_grad_cam per-head without grads rows=1 "
          f"row-normalised {bshape} f32: call {roll_bert[0]:.4f} ms "
          f"(head-mean pass {roll_bert[1]:.4f} ms, profiler), plain "
          f"{roll_bert[2]:.4f} ms {tag}")
    del bprobs32
    ids0, valid0, bidx0 = bert_batches[0]
    roll_names = sorted(device_ms(lambda: bex.explain(
        ids0, valid0, bidx0, method="rollout", start_layer=0), 1)[2])
    require(sum("rollout_head_mean" in k for k in roll_names) == 1
            and sum("rollout_chain" in k for k in roll_names) == 1,
            f"bert rollout batch: B1 launches {roll_names}")
    print(f"bert rollout batch (profiler): B1 launched "
          f"{[k[:40] for k in roll_names if 'rollout' in k]}")
    # B4 in the split path's bf16 mode, same shapes
    b4_bf16 = (time_ms(lambda: K.attn_fwd_core(qkv_main, h, hd, hd ** -0.5,
                                               "bfloat16"), 200),
               time_ms(lambda: K.attn_fwd_core_plain(qkv_main, h, hd,
                                                     hd ** -0.5, "bfloat16")))
    print(f"time attn_fwd_core {tuple(shapes['main'])} f32 bf16 mode (split "
          f"path): kernel {b4_bf16[0]:.4f} ms, plain {b4_bf16[1]:.4f} ms {tag}")
    # B5 at ViT-B/16 B=8, 12 heads, in exact FP32 and in the modes of the
    # tensor-parallel production preset (float32 recompute and gradient
    # products, bf16 rules) and of the split path (bf16 both); each with
    # its launches' device time (profiler: the row pass, the column pass,
    # the head mean); bounds below
    b5_args = cases["attn_rev_core"][0](*shapes["main"], torch.float32)
    b5_modes = {"exact FP32": ("float32", "float32"),
                "TP production": ("float32", "bfloat16"),
                "split path": ("bfloat16", "bfloat16")}
    b5_times = {}
    for label, (attn, rule) in b5_modes.items():
        kw = dict(attn_mxu=attn, rule_mxu=rule)
        b5_times[label] = (
            time_ms(lambda: K.attn_rev_core(*b5_args, **kw)),
            time_ms(lambda: K.attn_rev_core_plain(*b5_args, **kw)))
        per = device_ms(lambda: K.attn_rev_core(*b5_args, **kw))[2]
        print(f"time attn_rev_core {tuple(shapes['main'])} f32 {label} modes "
              f"(attn {attn}, rule {rule}): kernel {b5_times[label][0]:.4f} "
              f"ms, plain {b5_times[label][1]:.4f} ms; launches (profiler) "
              + "; ".join(f"{nm[:48]} {ms:.4f}" for nm, ms in sorted(
                  per.items(), key=lambda kv: -kv[1])) + f" {tag}")
    # B2's attention core (B4's tile with the anchors) alone: its launch's
    # device time in one block_fwd_core call, production modes (profiler)
    b2_launches = device_ms(lambda: K.block_fwd_core(bi["x"], bi["p32"],
                                                     *bi["fargs"]))[2]
    b2_core = sum(ms for nm, ms in b2_launches.items()
                  if "attn_fwd_kernel" in nm)
    print(f"time B2 attention core {tuple(shapes['main'])} f32 production "
          f"modes: launch {b2_core:.4f} ms of {sum(b2_launches.values()):.4f}"
          f" ms of B2's launches (profiler) {tag}")
    # the library yardstick of B10a and B10b: one bf16 torch.matmul per
    # product over each phase's five products, on the phase's own bf16
    # operands (phase 1: xn2·W1ᵀ, g_out·W2, hg·W2ᵀ, |hg|·|W2|ᵀ, g_h1·W1;
    # phase 2: Sr·W2, Sr·|W2|, |xn2|·|W1|ᵀ, S1·W1, S1·|W1|), the operands
    # formed by the plain versions' steps; device times summed (profiler;
    # printed only: the port never calls it)
    x_mid, g_out, ln2s_, ln2b_, b1_ = ti["a32"]
    w1_, w2_ = ti["w"]
    bf = "bfloat16"
    xn2 = bm.ln_fwd(x_mid, ln2s_, ln2b_, vit_eps)[0]
    fc1 = prec.kdot(xn2, prec.transpose(w1_), bf)
    h1 = fc1 + b1_
    hg = bm.gelu_exact(h1)
    g_h1 = prec.kdot(g_out, w2_, bf) * bm.gelu_grad(h1)
    Sr, fc1_b = ti["b32"][1], ti["b32"][2]
    hg2 = bm.gelu_exact(fc1_b + b1_)
    R2 = 0.5 * (hg2 * prec.kdot(Sr, w2_, bf)
                + hg2.abs() * prec.kdot(Sr, prec.kabs(w2_), bf))
    S1 = rp.safe_divide(R2, 0.5 * (fc1_b + prec.kdot(
        xn2.abs(), prec.transpose(prec.kabs(w1_)), bf)))
    W1, W2, aW1, aW2 = w1_[0], w2_[0], w1_.abs[0], w2_.abs[0]
    to16 = lambda t: t.reshape(-1, t.shape[-1]).to(torch.bfloat16)
    b10_mm = {"mlp_rev_tp_phase1": [(to16(xn2), W1.t()), (to16(g_out), W2),
                                    (to16(hg), W2.t()), (to16(hg.abs()),
                                                        aW2.t()),
                                    (to16(g_h1), W1)],
              "mlp_rev_tp_phase2": [(to16(Sr), W2), (to16(Sr), aW2),
                                    (to16(xn2.abs()), aW1.t()), (to16(S1), W1),
                                    (to16(S1), aW1)]}
    for name, pairs in b10_mm.items():
        parts = [device_ms(lambda: torch.matmul(x_, y_), 20)[0]
                 for x_, y_ in pairs]
        k_dev = device_ms(lambda: getattr(K, name)(*tp_args[name]), 20)
        print(f"time {name} {tp_shapes['main']} production modes: kernel "
              f"{times[name][0]:.4f} ms (events), {k_dev[0]:.4f} ms of "
              f"launches (profiler); torch.matmul bf16 on its five "
              f"products' bf16 operands, one call each: {sum(parts):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in parts)}) (profiler) {tag}")
    del x_mid, g_out, xn2, fc1, h1, hg, g_h1, Sr, fc1_b, hg2, R2, S1, b10_mm
    del block_inputs, bi, tp_inputs, ti, tp_args, qkv_main, q_, k_, v_
    del b6_inputs, b6, b6_args, b5_args
    # the GEMM core alone at each checked shape: its launch's device time
    # (profiler: a call of the core alone is shorter than the host's work
    # around it) and rate in bf16 passes (bf16x3 three, a dual GEMM two
    # products), beside torch.matmul on the same bf16-rounded operands, one
    # call per pass (a yardstick, printed only: the port never calls it)
    for label, (a, w, cargs, (rows, N_, K_)) in core_inputs.items():
        mode, wt, ab, du = cargs
        passes = (3 if mode == "tensorfloat32" else 1) * (2 if du else 1)
        flop = 2.0 * rows * N_ * K_ * passes
        t_k = device_ms(lambda: K.gemm_core(a, w, *cargs), 20)[0]
        a16 = (a.abs() if ab else a).to(torch.bfloat16)
        b16 = (w.abs if ab else w)[0]
        b16 = b16.t() if wt else b16
        t_mm = device_ms(lambda: torch.matmul(a16, b16), 20)[0]
        print(f"time core {label} ({rows}, {N_}, {K_}) {mode}: kernel "
              f"{t_k:.4f} ms, {flop / t_k / 1e9:.1f} TFLOP/s of bf16 passes; "
              f"torch.matmul bf16 {t_mm:.4f} ms a pass, "
              f"{2.0 * rows * N_ * K_ / t_mm / 1e9:.1f} TFLOP/s (profiler) "
              f"{tag}")
    # the tensor-parallel MLP kernels' instances of the core at B10's shapes
    # (phase 3's): device time and rate of their bf16 products, beside one
    # torch.matmul a product on bf16 operands of the same shapes
    for kind, (a0, w0, a1, w1, (M_, N_, K_), nprod) in fused_inputs.items():
        if kind == "bf16 A dual":
            call = lambda: K.gemm_core(a0, w0, "bfloat16", False, False, True)
        else:
            call = lambda: K.gemm_core_fused(kind, a0, w0, a1, w1)
        t_k = device_ms(call, 20)[0]
        x16 = a0.to(torch.bfloat16)
        y16 = w0[0].t() if w0[0].shape[1] == K_ else w0[0]
        t_mm = device_ms(lambda: torch.matmul(x16, y16), 20)[0]
        flop = 2.0 * M_ * N_ * K_ * nprod
        print(f"time core B10 {kind} ({M_}, {N_}, {K_}) x{nprod} bfloat16: "
              f"kernel {t_k:.4f} ms, {flop / t_k / 1e9:.1f} TFLOP/s; "
              f"torch.matmul bf16 {t_mm:.4f} ms a product, "
              f"{2.0 * M_ * N_ * K_ / t_mm / 1e9:.1f} TFLOP/s (profiler) "
              f"{tag}")
    del core_inputs, fused_inputs, a16, b16, x16, y16

    imgs_t = torch.as_tensor(batches[0][0], device=dev)
    idx_t = torch.as_tensor(batches[0][1], device=dev)

    def rate(ops, nb=20, model=None, imgs=None, **kw):
        model = model or ex.model
        imgs = imgs_t if imgs is None else imgs
        for _ in range(3):
            explain_batch(model, imgs, idx_t, ops=ops, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(nb):
            explain_batch(model, imgs, idx_t, ops=ops, **kw)
        torch.cuda.synchronize()
        return nb * 8 / (time.perf_counter() - t)

    def peak_gib(ops, model=None, imgs=None, **kw):
        """Device memory one batch needs above what is resident (models,
        prepared weights, references)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        explain_batch(model or ex.model, imgs_t if imgs is None else imgs,
                      idx_t, ops=ops, **kw)
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
    # the split path beside the megakernel path of the same preset, in
    # alternating windows: split kernels, split plain, megakernel, split
    # kernels, megakernel
    peak_s = peak_gib(K.KERNEL_OPS, **split)
    rs = [rate(K.KERNEL_OPS, **split), rate(K.PLAIN_OPS, **split),
          rate(K.KERNEL_OPS, **bf16), rate(K.KERNEL_OPS, **split),
          rate(K.KERNEL_OPS, **bf16)]
    print(f"e2e transformer_attribution ViT-B/16 bfloat16 split path "
          f"(block_kernel=False) B=8, 20-batch windows: kernel path "
          f"{rs[0]:.2f} / {rs[3]:.2f} expl/s, plain path {rs[1]:.2f} expl/s, "
          f"batch working memory {peak_s:.3f} GiB; megakernel bfloat16 path "
          f"{rs[2]:.2f} / {rs[4]:.2f} expl/s {tag}")
    # each method in exact FP32, kernels (the rollout kernel, and B4/B5 on
    # the fused method's kernel branch)
    for m, variant, kw in method_runs:
        r = rate(K.KERNEL_OPS, method=m, variant=variant, **kw)
        print(f"e2e method {m} variant {variant} {kw} ViT-B/16 "
              f"float32 B=8, 20-batch window: {r:.2f} expl/s {tag}")
    # ViT-L/16 and DeiT-base distilled, transformer_attribution in exact
    # FP32 and production: kernel path, plain path (5 batches), kernel path
    for (mname, label), exm in new_explainers.items():
        if label == "rollout_attn":
            continue
        kw = prod if label == "production" else {}
        peak_n = peak_gib(K.KERNEL_OPS, model=exm.model, **kw)
        r1 = rate(K.KERNEL_OPS, model=exm.model, **kw)
        r0 = rate(K.PLAIN_OPS, nb=5, model=exm.model, **kw)
        r2 = rate(K.KERNEL_OPS, model=exm.model, **kw)
        print(f"e2e transformer_attribution {mname} {label} B=8, 20-batch "
              f"windows: kernel path {r1:.2f} / {r2:.2f} expl/s, plain path "
              f"{r0:.2f} expl/s (5-batch window), batch working memory "
              f"{peak_n:.3f} GiB {tag}")
    del new_explainers
    # ViT-B/16 at 384 px (n = 577), the first 384-px batch, both presets:
    # kernel path, plain path (5 batches), kernel path
    for label, m384 in models384.items():
        kw = prod if label == "production" else {}
        peak_n = peak_gib(K.KERNEL_OPS, model=m384, imgs=imgs384_t, **kw)
        r1 = rate(K.KERNEL_OPS, model=m384, imgs=imgs384_t, **kw)
        r0 = rate(K.PLAIN_OPS, nb=5, model=m384, imgs=imgs384_t, **kw)
        r2 = rate(K.KERNEL_OPS, model=m384, imgs=imgs384_t, **kw)
        print(f"e2e transformer_attribution ViT-B/16 384px {label} B=8, "
              f"20-batch windows: kernel path {r1:.2f} / {r2:.2f} expl/s, "
              f"plain path {r0:.2f} expl/s (5-batch window), batch working "
              f"memory {peak_n:.3f} GiB {tag}")
    del models384, imgs384_t
    torch.cuda.empty_cache()

    def tp_rate(fn, sh, nb=20):
        for _ in range(3):
            fn(sh, imgs_t, idx_t)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(nb):
            fn(sh, imgs_t, idx_t)
        torch.cuda.synchronize()
        return nb * 8 / (time.perf_counter() - t)

    for label, (fn, plain_fn, sh32) in tp.items():
        r1, r0, r2 = (tp_rate(fn, sh32), tp_rate(plain_fn, sh32),
                      tp_rate(fn, sh32))
        print(f"e2e transformer_attribution ViT-B/16 tensor-parallel k=1 "
              f"{label} B=8, 20-batch windows: kernel path {r1:.2f} / "
              f"{r2:.2f} expl/s, plain path {r0:.2f} expl/s {tag}")
    del tp
    dist.destroy_process_group()

    bi = bert_inputs
    times["bert_layer_fwd_core"] = (
        time_ms(lambda: K.bert_layer_fwd_core(bi["x"], bi["m"], bi["p32"],
                                              *bi["fargs"], save_attn=True)),
        time_ms(lambda: bmath.bert_layer_fwd_core_plain(
            bi["x"], bi["m"], bi["p32"], *bi["fargs"], save_attn=True)))
    times["bert_out_rev_core"] = (
        time_ms(lambda: K.bert_out_rev_core(*bi["o32"], bi["p32"],
                                            *bi["oargs"])),
        time_ms(lambda: bmath.bert_out_rev_core_plain(*bi["o32"], bi["p32"],
                                                      *bi["oargs"])))
    times["bert_attn_rev_core"] = (
        time_ms(lambda: K.bert_attn_rev_core(*bi["a32"], bi["p32"],
                                             *bi["aargs"], saved=bi["s32"])),
        time_ms(lambda: bmath.bert_attn_rev_core_plain(
            *bi["a32"], bi["p32"], *bi["aargs"], saved=bi["s32"])))
    for name in ("bert_layer_fwd_core", "bert_out_rev_core",
                 "bert_attn_rev_core"):
        print(f"time {name} {bert_shapes['main']} f32 production modes: "
              f"kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} "
              f"ms {tag}")
    # B9 at S=128, from the forward kernel's own anchors
    S_s, D_b = 128, bcfg.hidden_size
    keep = (torch.arange(S_s, device=dev)[None, :]
            < (S_s - 16 * torch.arange(8, device=dev))[:, None])
    m_s = (1.0 - keep.float()) * bcfg.mask_value
    x_s, g_s, r_s = (randn(8, S_s, D_b, dtype=torch.float32)
                     for _ in range(3))
    sv_s = K.bert_layer_fwd_core(x_s, m_s, bi["p32"], *bi["fargs"],
                                 save_attn=True)[2:]
    b9_s = (x_s, g_s, r_s, m_s, bi["p32"], *bi["aargs"])
    b9_128 = (time_ms(lambda: K.bert_attn_rev_core(*b9_s, saved=sv_s)),
              time_ms(lambda: bmath.bert_attn_rev_core_plain(*b9_s,
                                                             saved=sv_s)))
    print(f"time bert_attn_rev_core (8, {S_s}, {bcfg.num_heads}, "
          f"{bcfg.head_dim}) f32 production modes: kernel {b9_128[0]:.4f} "
          f"ms, plain {b9_128[1]:.4f} ms {tag}")
    b7_s = (x_s, m_s, bi["p32"], *bi["fargs"])
    b7_128 = (time_ms(lambda: K.bert_layer_fwd_core(*b7_s, save_attn=True)),
              time_ms(lambda: bmath.bert_layer_fwd_core_plain(
                  *b7_s, save_attn=True)))
    print(f"time bert_layer_fwd_core (8, {S_s}, {bcfg.num_heads}, "
          f"{bcfg.head_dim}) f32 production modes: kernel {b7_128[0]:.4f} "
          f"ms, plain {b7_128[1]:.4f} ms {tag}")
    del x_s, g_s, r_s, m_s, sv_s, b9_s, b7_s
    # B7's attention core alone (its launch's device time, profiler) beside
    # scaled_dot_product_attention with the additive mask on the same float32
    # q, k, v (qkv_pre + b_qkv) at S=512 (timed only; the port never calls it)
    b7_call = lambda: K.bert_layer_fwd_core(bi["x"], bi["m"], bi["p32"],
                                            *bi["fargs"], save_attn=True)
    b7_launches = device_ms(b7_call)[2]
    core_ms = sum(ms for name, ms in b7_launches.items()
                  if "bert_attn_fwd_kernel" in name)
    qkv_b = b7_call()[2] + bi["p32"].b_qkv
    hb, hdb = bcfg.num_heads, bcfg.head_dim
    qb, kb, vb = (t.contiguous() for t in bm.split_heads(qkv_b, hb, hdb))
    mask4 = bi["m"][:, None, None, :]        # (B, 1, 1, S), broadcast
    sdpa_m = lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask4, scale=hdb ** -0.5)
    sdpa_m_ms = time_ms(sdpa_m, 50)
    sdpa_m_dev = device_ms(sdpa_m)
    print(f"time B7 attention core (8, {qb.shape[2]}, {hb}, {hdb}) f32: launch "
          f"{core_ms:.4f} ms (profiler); scaled_dot_product_attention with "
          f"the additive mask {sdpa_m_ms:.4f} ms (events), "
          f"{sdpa_m_dev[0]:.4f} ms (profiler), ran: "
          f"{'; '.join(sdpa_m_dev[1]) or 'no kernel seen'} {tag}")
    print("B7 launches (profiler, ms per call): " + "; ".join(
        f"{name[:60]} {ms:.4f}" for name, ms in sorted(
            b7_launches.items(), key=lambda kv: -kv[1])) + f" {tag}")
    del qkv_b, qb, kb, vb, mask4
    del bert_inputs, bi
    torch.cuda.empty_cache()

    def bert_rate(S, ops, nb=20, **kw):
        ids, valid, idx = bert_batches[0]
        args = (torch.as_tensor(ids[:, :S], device=dev),
                torch.as_tensor(valid[:, :S], device=dev),
                torch.as_tensor(idx, device=dev))
        for _ in range(3):
            bg.explain_batch(bex.model, *args, ops=ops, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(nb):
            bg.explain_batch(bex.model, *args, ops=ops, **kw)
        torch.cuda.synchronize()
        return nb * 8 / (time.perf_counter() - t)

    for S in (512, 128):
        for label, kw in (("float32", {}), ("production", prod)):
            r1 = bert_rate(S, K.BERT_KERNEL_OPS, **kw)
            r0 = bert_rate(S, K.BERT_PLAIN_OPS, **kw)
            r2 = bert_rate(S, K.BERT_KERNEL_OPS, **kw)
            print(f"e2e transformer_attribution BERT-base {label} B=8 S={S}, "
                  f"20-batch windows: kernel path {r1:.2f} / {r2:.2f} "
                  f"expl/s, plain path {r0:.2f} expl/s {tag}")
    # each BERT method in exact FP32 (the rollout kernel where the method
    # rolls out)
    for m, variant, kw in bert_method_runs:
        r = bert_rate(512, K.BERT_KERNEL_OPS, method=m, variant=variant, **kw)
        print(f"e2e bert method {m} variant {variant} {kw} BERT-base float32 "
              f"B=8 S=512, 20-batch window: {r:.2f} expl/s {tag}")

    # bound_ms: the least time the card could take for each timed call's
    # work, the larger of its bytes (each input read once, each output
    # written once) over the memory rate and its products' operations over
    # the peak rate of their type: bf16 products on the tensor cores, a
    # bf16x3 product as three bf16 passes, float32 products off the tensor
    # cores (elementwise work is not counted). Shapes as timed above.
    def bound(nbytes, bf16=0, bf16x3=0, f32=0):
        t_mem = nbytes / HBM_BYTES_S
        t_ops = (bf16 + 3 * bf16x3) / BF16_FLOPS + f32 / FP32_FLOPS
        return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                          else "operations")

    f4 = 4                              # bytes of a float32 activation

    def vit_work(b, nn_, hh, dd, ml, ll):
        """(bytes, operations) of each ViT kernel's call at B=b, n=nn_,
        h=hh, hd=dd, M=ml and ll blocks, in the modes timed (B4, B5, B1
        exact FP32; B2, B3, B10 production; B6 the split path's)."""
        D_, R_ = hh * dd, b * nn_
        at = b * hh * nn_ * nn_ * dd    # half the FLOPs of an (n, n, hd)
        pr = 4 * 4 * D_ * D_            # qkv + proj as bf16 (hi, lo) pairs
        return {
            "attn_fwd_core": (f4 * 4 * R_ * D_, dict(f32=4 * at)),
            "attn_rev_core": (f4 * (11 * R_ * D_ + b * nn_ * nn_),
                              dict(f32=20 * at)),
            # B1's row form (the kernels line): row 0 of the last layer's
            # maps and the other layers' whole maps read once, row 0
            # written; a vector-matrix product a layer after the first
            "rollout_from_grad_cam": (
                f4 * ((ll - 1) * b * nn_ * nn_ + 2 * b * nn_),
                dict(f32=2 * b * (ll - 1) * nn_ * nn_)),
            "rollout_from_grad_cam full": (
                f4 * (ll + 1) * b * nn_ * nn_,
                dict(f32=2 * b * (ll - 1) * nn_ ** 3)),
            "block_fwd_core": (
                f4 * (9 * D_ + ml) + pr + 2 * 2 * ml * D_
                + f4 * (R_ * D_ + 8 * R_ * D_ + 2 * b * hh * nn_ * nn_
                        + R_ * ml),
                dict(bf16x3=8 * R_ * D_ * D_, f32=4 * at,
                     bf16=4 * R_ * D_ * ml)),
            "block_rev_core": (
                f4 * (9 * D_ + ml) + pr + 2 * 2 * ml * D_
                + f4 * (10 * R_ * D_ + 2 * b * hh * nn_ * nn_ + R_ * ml)
                + f4 * (2 * R_ * D_ + b * nn_ * nn_),
                dict(bf16=16 * R_ * D_ * ml + 24 * R_ * D_ * D_ + 8 * at,
                     bf16x3=8 * R_ * D_ * D_, f32=8 * at)),
            "mlp_rev_tp_phase1": (
                f4 * (2 * D_ + ml + 2 * R_ * D_) + 2 * 2 * ml * D_
                + f4 * (R_ * ml + 3 * R_ * D_), dict(bf16=10 * R_ * D_ * ml)),
            "mlp_rev_tp_phase2": (
                f4 * (2 * D_ + ml + 2 * R_ * D_ + R_ * ml) + 2 * 2 * ml * D_
                + f4 * 2 * R_ * D_, dict(bf16=10 * R_ * D_ * ml)),
            # ten products of 2·R·D·M (fc1, fc2, the two backward products,
            # the two |x|·|W| denominators and the two dual GEMMs' four),
            # one bf16 pass each in the split path's modes
            "mlp_rev_core": (
                f4 * (3 * D_ + ml + 3 * R_ * D_) + 2 * 2 * ml * D_
                + f4 * 2 * R_ * D_, dict(bf16=20 * R_ * D_ * ml)),
        }

    Dm, Mm, R = cfg.embed_dim, cfg.mlp_dim, B * n
    att = B * h * n * n * hd        # half the FLOPs of one (n, n, hd) product
    Sb, Ib = bert_shapes["main"][1], bcfg.intermediate_size
    Rb, attb = 8 * Sb, 8 * h * Sb * Sb * hd
    pair = 4 * 4 * Dm * Dm              # qkv + proj as bf16 (hi, lo) pairs
    work = {
        **vit_work(B, n, h, hd, Mm, L),
        "bert_layer_fwd_core": (
            f4 * (9 * Dm + Ib + Rb * Dm + 8 * Sb) + pair + 2 * 2 * Ib * Dm
            + f4 * 7 * Rb * Dm,
            dict(bf16x3=8 * Rb * Dm * Dm, f32=4 * attb,
                 bf16=4 * Rb * Dm * Ib)),
        "bert_out_rev_core": (
            f4 * (9 * Dm + Ib + 3 * Rb * Dm) + 2 * 2 * Ib * Dm
            + f4 * 2 * Rb * Dm, dict(bf16=20 * Rb * Dm * Ib)),
        "bert_attn_rev_core": (
            f4 * (9 * Dm + Ib + 8 * Rb * Dm + 8 * Sb) + pair
            + f4 * (2 * Rb * Dm + 8 * Sb * Sb),
            dict(f32=10 * attb, bf16=8 * attb + 24 * Rb * Dm * Dm,
                 bf16x3=8 * Rb * Dm * Dm)),
    }
    bounds = {name: bound(nb, **ops) for name, (nb, ops) in work.items()}
    sources = {"attn_fwd_core": "attn_fwd.cu", "attn_rev_core": "attn_rev.cu",
               "rollout_from_grad_cam": "rollout.cu",
               "block_fwd_core": "block_fwd.cu",
               "block_rev_core": "block_rev.cu",
               "bert_layer_fwd_core": "bert_fwd.cu",
               "bert_out_rev_core": "bert_out_rev.cu",
               "bert_attn_rev_core": "bert_attn_rev.cu",
               "mlp_rev_tp_phase1": "mlp_rev_tp.cu",
               "mlp_rev_tp_phase2": "mlp_rev_tp.cu",
               "mlp_rev_core": "mlp_rev.cu"}
    tpu_lines = {"attn_fwd_core": 391, "attn_rev_core": 415,
                 "rollout_from_grad_cam": 49, "block_fwd_core": 1378,
                 "block_rev_core": 1223, "bert_layer_fwd_core": 2335,
                 "bert_out_rev_core": 2011, "bert_attn_rev_core": 2163,
                 "mlp_rev_tp_phase1": 892, "mlp_rev_tp_phase2": 937,
                 "mlp_rev_core": 733}
    for name in sources:
        print(f"bound {name}: {bounds[name][0]:.4f} ms ({bounds[name][1]}); "
              f"kernel {times[name][0]:.4f} ms {tag}")
    # B5's ten products by mode: the recompute and gradient products (six)
    # at the attention mode's rate, the rule products (four) at the rule
    # mode's; B2's attention core: B4's two products and its stores
    for label, (attn, rule) in b5_modes.items():
        ops = {"f32": 0, "bf16": 0}
        ops["bf16" if attn == "bfloat16" else "f32"] += 12 * att
        ops["bf16" if rule == "bfloat16" else "f32"] += 8 * att
        bd = bound(work["attn_rev_core"][0], **ops)
        print(f"bound attn_rev_core {label} modes: {bd[0]:.4f} ms ({bd[1]}); "
              f"kernel {b5_times[label][0]:.4f} ms {tag}")
    bd = bound(f4 * (4 * R * Dm + 2 * B * h * n * n), f32=4 * att)
    print(f"bound B2 attention core (float32 products, dots and probs "
          f"stored): {bd[0]:.4f} ms ({bd[1]}); launch {b2_core:.4f} ms {tag}")
    bd = bounds["rollout_from_grad_cam full"]
    print(f"bound rollout_from_grad_cam full form: {bd[0]:.4f} ms ({bd[1]}); "
          f"kernel {roll_full[0]:.4f} ms {tag}")
    # the head-mean pass: the head maps (and grads) read once, the
    # (B, L, n, n) mean written
    for label, (_, pass_ms, _) in roll_heads.items():
        reads = 2 if label == "with grads" else 1
        bd = bound(f4 * (reads + 1.0 / h) * B * L * h * n * n)
        print(f"bound rollout_from_grad_cam head-mean pass {label}: "
              f"{bd[0]:.4f} ms ({bd[1]}); launch {pass_ms:.4f} ms {tag}")
    bd = bound(f4 * (1 + 1.0 / bcfg.num_heads) * float(np.prod(bshape)))
    print(f"bound rollout_from_grad_cam head-mean pass without grads at "
          f"BERT-base {bshape}, start 0: {bd[0]:.4f} ms ({bd[1]}); launch "
          f"{roll_bert[1]:.4f} ms ({roll_bert[1] / bd[0]:.2f}x) {tag}")
    # each kernel at the other configurations' shapes (ViT-L/16; n = 198),
    # from phase 3's inputs there: ms per call (CUDA events; B1's row form
    # its launch's device time, profiler) beside its plain version and its
    # bound at that shape, in the modes of the kernels line
    for sname, (b, nn_, hh, dd, ll) in new_shapes.items():
        shp, ml, ni = (b, nn_, hh, dd), 4 * hh * dd, new_inputs[sname]
        t = {}
        for name in ("attn_fwd_core", "attn_rev_core"):
            make, kern, plain = cases[name]
            args = make(*shp, torch.float32)
            t[name] = (time_ms(lambda: kern(*args),
                               200 if name == "attn_fwd_core" else 20),
                       time_ms(lambda: plain(*args)))
        c32 = randn(b, ll, nn_, nn_, dtype=torch.float32).abs() * 1e-3
        t["rollout_from_grad_cam"] = (
            device_ms(lambda: K.rollout_from_grad_cam(c32, 0, rows=1))[0],
            time_ms(lambda: K.rollout_plain(c32, 0, rows=1)))
        bk = ni["block"]
        t["block_fwd_core"] = (
            time_ms(lambda: K.block_fwd_core(bk["x"], bk["p32"],
                                             *bk["fargs"])),
            time_ms(lambda: bm.block_fwd_core_plain(bk["x"], bk["p32"],
                                                    *bk["fargs"])))
        t["block_rev_core"] = (
            time_ms(lambda: K.block_rev_core(*bk["a32"], bk["p32"],
                                             *bk["rargs"], saved=bk["s32"])),
            time_ms(lambda: bm.block_rev_core_plain(
                *bk["a32"], bk["p32"], *bk["rargs"], saved=bk["s32"])))
        tk = ni["b10"]
        for name, args in (
                ("mlp_rev_tp_phase1", (*tk["a32"], *tk["w"], vit_eps,
                                       tk["mlp"], tk["rule"])),
                ("mlp_rev_tp_phase2", (*tk["b32"], *tk["w"], vit_eps,
                                       tk["rule"]))):
            t[name] = (time_ms(lambda: getattr(K, name)(*args)),
                       time_ms(lambda: getattr(K, name + "_plain")(*args)))
        b6k = ni["b6"]
        args = (*b6k["a32"], b6k["p32"], vit_eps, b6k["mlp"], b6k["rule"])
        t["mlp_rev_core"] = (time_ms(lambda: K.mlp_rev_core(*args)),
                             time_ms(lambda: K.mlp_rev_core_plain(*args)))
        wk = vit_work(b, nn_, hh, dd, ml, ll)
        for name, (ms, pms) in t.items():
            bd = bound(wk[name][0], **wk[name][1])
            print(f"time {name} {sname} (B, n, h, hd, M, L) "
                  f"{(b, nn_, hh, dd, ml, ll)}: kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
                  f"{ms / bd[0]:.1f}x the bound {tag}")
        del t, c32, bk, tk, b6k, args
    del new_inputs
    # B1-B5 at ViT-B/16 384 px (n = 577), from phase 3's inputs there: ms
    # per call (CUDA events; B1's row form its launch's device time,
    # profiler) beside the plain version and the bound at that shape, in
    # the kernels line's modes (B4, B5, B1 exact FP32; B2, B3 production)
    t = {}
    for name in ("attn_fwd_core", "attn_rev_core"):
        make, kern, plain = cases[name]
        args = make(*shape577, torch.float32)
        t[name] = (time_ms(lambda: kern(*args),
                           200 if name == "attn_fwd_core" else 20),
                   time_ms(lambda: plain(*args)))
    c32 = randn(B, L, 577, 577, dtype=torch.float32).abs() * 1e-3
    t["rollout_from_grad_cam"] = (
        device_ms(lambda: K.rollout_from_grad_cam(c32, 0, rows=1))[0],
        time_ms(lambda: K.rollout_plain(c32, 0, rows=1)))
    bk = block577
    t["block_fwd_core"] = (
        time_ms(lambda: K.block_fwd_core(bk["x"], bk["p32"], *bk["fargs"])),
        time_ms(lambda: bm.block_fwd_core_plain(bk["x"], bk["p32"],
                                                *bk["fargs"])))
    t["block_rev_core"] = (
        time_ms(lambda: K.block_rev_core(*bk["a32"], bk["p32"], *bk["rargs"],
                                         saved=bk["s32"])),
        time_ms(lambda: bm.block_rev_core_plain(
            *bk["a32"], bk["p32"], *bk["rargs"], saved=bk["s32"])))
    wk = vit_work(B, 577, h, hd, cfg.mlp_dim, L)
    for name, (ms, pms) in t.items():
        bd = bound(wk[name][0], **wk[name][1])
        print(f"time {name} n=577 (B, n, h, hd, M, L) "
              f"{(B, 577, h, hd, cfg.mlp_dim, L)}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
              f"{ms / bd[0]:.1f}x the bound {tag}")
    del t, c32, bk, block577, args
    print(f"elapsed {time.perf_counter() - t_start:.0f} s")
    slices = (launches, launches_prod, launches_split, launches_bf16,
              launches_diag, launches_mlp, *method_launches, *new_launches,
              blaunches, blaunches_prod, *bert_method_launches,
              *tp_launches, *ckpt_launches, *launches384,
              *harness_launches)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"transformer_explainability_torch/csrc/{sources[name]}",
         "replaces": f"{TPU_KERNELS}:{tpu_lines[name]}",
         "launches": sum(c[name] for c in slices),
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library[name]}
        for name in sources]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
