#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):
  1. device: a CUDA card, its name and power limit, TF32 off, and which of
     PIL, h5py, sklearn, matplotlib, cv2, safetensors, tqdm and
     transformers import (printed; nothing is gated on it but the optional
     cases below);
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
     C5 on B6 and C8 on B8's R_att and the tensor-parallel MLP half
     (B10a -> B10b) with bf16x3 MLP products: 16 input draws each beside
     the plain float32 version on ulp-moved copies (printed);
  4. slices, each driven with the launch counts set to 0 just before and
     read just after: ``Explainer(params, VIT_BASE_16_224, device="cuda")``
     (exact FP32) and ``Explainer(..., **precision_kwargs("production"))``
     explain three batches of 8 images, and ``BertExplainer(params,
     BERT_BASE_UNCASED, ...)`` in both presets three batches of 8 padded
     sequences at S=512 (random weights from a seeded generator); output
     shape, finiteness, bitwise repeatability, launch counts per batch, and
     the per-sample Pearson correlation (BERT: over each sample's tokens)
     against the port's plain path of the same preset in float64 on the
     same card (exact FP32, ``sample_gate``: >= 0.999 on every sample
     where the plain float32 path reaches 0.999, else no lower than its
     corr - 0.01, on ViT-B and TP with a witness: the kernel path on the
     weights moved one float32 ulp reaches 0.999 on that sample; the
     reduced presets, ``preset_gate``: the kernel path as one more draw
     beside PLAIN_DRAWS plain float32 draws, the weights as they are and
     moved one float32 ulp: median >= min(0.999, each draw's median -
     MED_SLACK), no more samples below 0.99 than the worst draw + 1, min
     >= the draws' min - 0.01 except on a sample the kernel path's own
     draws on the moved weights witness (one reaches the plain draws'
     lowest there - 0.01); the presets are ill-conditioned on some
     random-weight samples for any float32 implementation); the
     production paths' corr against the
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
     implementation), DeiT's float32 runs by the methods' rule, the plain
     float32 draws the weights as they are and moved one float32 ulp (two
     in float32, PLAIN_DRAWS in production); the tensor-parallel program
     on DeiT at k = 1 in float32 against the single-device plain float64
     path by the same rule;
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
     the reduced bases (``reduced_base_phase``): each ViT-B/16 method off
     the kernel branch at ``bfloat16`` and ``production``, ``lrp`` and
     alpha = 2 at ``production``, float32 rules on the ``bfloat16`` base
     and bf16 attention and rule islands on the ``float32`` base (B4, B5
     in their bf16 modes), and BERT-base's five other methods at both
     presets (S = 512), B = 8 each, through ``Explainer`` /
     ``BertExplainer``, launches counted at full depth; on the first
     REDUCED_DEPTH blocks (layers) of the same weights, the float32 maps
     by ``preset_gate`` (witnessed) on REDUCED_SAMPLES samples against the
     same path in float64 on the card, the plain draws that path in
     float32 on the card machine's CPU (the weights as they are and moved
     one f32 ulp), the witnesses the card's path on other moved weights;
     that float64 path held to the CPU's within TWIN_GAP of corr 1; at
     full depth, fidelity against the exact float64 path beside exact
     FP32's and expl/s printed (build/reduced_bases.json);
     the seg harness runs rollout at production too;
     the guarded mode (``guarded_phase``, after the BERT methods): the
     strict and envelope guards of ``make_guarded_explain_fn``, the
     exact-CPU verifier, ``GuardedServer`` with its gpu-f32 tier, the
     deliver-f32 policy under an escalation budget and the uint8 wire
     format on ViT-B/16, and BERT-base's strict mode, by gates (a)-(g) of
     PERF.md §2 (heatmaps and scores bitwise their programs', the tier's
     accounting, the exact-CPU rows against the plain float64 path);
     the training paths (``training_phases``): ``create_model(name,
     seed=0, device="cuda")`` bitwise the CPU draw moved to the card, for
     ViT-B/16 and BERT-base (a seed is one model on every device); the
     ViT-B/16 trainer (``train.init_train_state`` / ``make_train_step``) at
     B=32 for 5 steps on a fixed seeded batch in ``float32`` and
     ``bfloat16`` (losses finite and falling, ms a step; no kernel
     launched), one ``float32`` step's clipped gradients within
     GRAD_REL_L2 of the same step in float64 on the card, and a
     ``save_train_state`` / ``restore_train_state`` round trip followed by
     a step bitwise the uninterrupted step; then the ERASER pipeline at
     BERT-base's width on a synthetic layout written under build/ (40
     train, 16 val, 32 test annotations, documents past 512 wordpieces, a
     local vocab and a wordpiece stand-in tokenizer): ``train_classifier``
     for 2 epochs (batch 10, lr 1e-5, clip 1, dropout 0.1) and again (it
     resumes as done), the step alone timed, ``explain_test_split`` at
     ``float32`` (B1) and ``bfloat16`` (B7, B8, B9, B1), launches counted,
     each map gated against the plain float64 path on the same card and
     weights (``float32`` by ``sample_gate``; ``bfloat16`` by
     ``preset_gate`` against the plain float32 path), expl/s printed, the
     hard rationales scored by ``score_results`` (the soft and
     classification scores too where phase 1 found scikit-learn), and,
     where phase 1 found transformers, ``run_pipeline`` once on the
     written vocab (its tokenizer's ids checked equal to the stand-in's);
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
checkpoint, 384-px, harness and training runs included; error, kernel,
plain, bound and library times).
"""

import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import warnings

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
# the presets (production, bfloat16, the split path) are ill-conditioned on
# some random-weight samples for any float32 implementation: moving every
# weight one float32 ulp moves such a sample's answer as far as the
# kernels' roundings do (PERF.md, PR 17). Their gates (preset_gate) hold the
# kernel path as one more draw against PLAIN_DRAWS draws of the plain
# float32 path, each a real float32 implementation: the weights as they are
# and moved one float32 ulp (seeded); the kernel path on those moved weights
# is the witness of a sample it takes below the plain draws' minimum
PLAIN_DRAWS = 5
# the room a kernel path's median corr has below a plain float32 draw's
# median where that is below MIN_CORR + MED_SLACK: about twice the widest
# gap to the plain path on the same weights measured on an H100 (BERT
# production, 0.997701 against 0.998274; PERF.md, PR 17)
MED_SLACK = 0.001
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
# the batches of 8 in each timed window of phase 5's rates (after 3 warm-up
# batches)
RATE_BATCHES = 10
# the optional packages the port's readers and writers import lazily
OPTIONAL_PACKAGES = ("PIL", "h5py", "sklearn", "matplotlib", "cv2",
                     "safetensors", "tqdm", "transformers")
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


def fmt(a):
    return np.array2string(np.asarray(a), precision=6, max_line_width=1000)


def preset_gate(label, c, p_draws, k_draws=(), witnessed=False):
    """The gate of every reduced preset (production, bfloat16, the split
    path, the MLP split; ViT-L's exact FP32 too, ill-conditioned at 24
    blocks) against the plain float32 path of the same preset. ``c`` is
    the kernel path's per-sample corr against the plain float64 path,
    ``p_draws`` the plain float32 path's, on the weights as they are
    (first) and on the weights moved one float32 ulp, and ``k_draws`` the
    kernel path's on those moved weights. Each plain draw is a real
    float32 implementation, and the kernel path is held as one more:
    its median >= MIN_CORR, or >= each plain draw's median - MED_SLACK
    where that is lower; no more samples below TAIL_CORR than
    the worst plain draw + 1; its min >= the plain draws' min -
    PROD_MIN_SLACK, except on a sample that the kernel path's own draws
    witness as ill-conditioned for it too: one of them reaches the plain
    draws' lowest on that sample - PROD_MIN_SLACK (a fault of the kernel
    path holds on every draw of the weights).

    With ``witnessed`` (a pair whose every sample may be ill-conditioned,
    where the path's answer on any float32 draw is one more random draw
    and no path can be held to beat the best plain draw): the median floor
    is the lowest plain draw's median - MED_SLACK where that is below
    MIN_CORR, and the median and the tail rules, like the min rule, fail
    only where the kernel path's every draw fails them: as it is and on
    each set of moved weights."""
    c = np.asarray(c)
    p_draws = [np.asarray(p) for p in p_draws]
    p_med = [float(np.median(p)) for p in p_draws]
    p_tail = [int((p < TAIL_CORR).sum()) for p in p_draws]
    p_min = [float(p.min()) for p in p_draws]
    k_tail = int((c < TAIL_CORR).sum())
    med_floor = min(MIN_CORR, (min(p_med) if witnessed else max(p_med))
                    - MED_SLACK)
    tail_cap = max(p_tail) + 1
    low = c < min(p_min) - PROD_MIN_SLACK
    p_low = np.min(p_draws, axis=0)
    k_best = (np.max(k_draws, axis=0) if len(k_draws)
              else np.full_like(c, -np.inf))
    bad = low & (k_best < p_low - PROD_MIN_SLACK)
    print(f"{label} corr vs plain f64 on the card: min {c.min():.6f} "
          f"median {np.median(c):.6f}, {k_tail} below {TAIL_CORR}; plain "
          f"f32 draws (as they are, then moved one f32 ulp): min "
          f"{fmt(p_min)} median {fmt(p_med)} below {TAIL_CORR} {p_tail}; "
          f"per sample {fmt(c)}, plain f32 path {fmt(p_draws[0])}, lowest "
          f"plain draw {fmt(p_low)}")
    for j, k in enumerate(k_draws):
        print(f"{label} kernel path on the moved weights, draw {j + 1}: min "
              f"{k.min():.6f} median {np.median(k):.6f}, "
              f"{int((k < TAIL_CORR).sum())} below {TAIL_CORR}")
    if low.any():
        print(f"{label} samples {np.flatnonzero(low).tolist()} below the "
              f"plain draws' min {min(p_min):.6f} - {PROD_MIN_SLACK}: kernel "
              f"path {fmt(c[low])}, its best draw on the moved weights "
              f"{fmt(k_best[low])}, the plain draws' lowest there "
              f"{fmt(p_low[low])}")
    k_med = [float(np.median(k)) for k in k_draws] if witnessed else []
    k_tails = [int((k < TAIL_CORR).sum()) for k in k_draws] if witnessed \
        else []
    require(np.median(c) >= med_floor or any(m >= med_floor for m in k_med),
            f"{label}: median corr {np.median(c):.6f} below "
            f"{med_floor:.6f}" + (f", and each draw on the moved weights "
                                  f"too ({fmt(k_med)})" if witnessed else ""))
    require(k_tail <= tail_cap or any(t <= tail_cap for t in k_tails),
            f"{label}: {k_tail} samples below {TAIL_CORR}, the worst plain "
            f"f32 draw {max(p_tail)}" + (f", and each draw on the moved "
                                         f"weights too ({k_tails})"
                                         if witnessed else ""))
    require(not bad.any(), f"{label}: samples {np.flatnonzero(bad).tolist()}"
            f" at {fmt(c[bad])} below the plain draws' min {min(p_min):.6f}"
            f" - {PROD_MIN_SLACK}, and no draw of the kernel path on the "
            f"moved weights reaches the plain draws' lowest there")


def sample_gate(label, c, c_plain, k_draws=None):
    """Exact FP32's per-sample rule: >= MIN_CORR on every sample where the
    plain float32 path (``c_plain``, the lowest of its draws) reaches
    MIN_CORR too; where it does not, exact FP32 is ill-conditioned there
    for any float32 implementation, and the kernel path may fall no lower
    than the plain path's corr - PROD_MIN_SLACK. With ``k_draws`` (the
    kernel path on the weights moved one float32 ulp) such a sample must
    also be witnessed as ill-conditioned for the kernel path: one of its
    draws reaches MIN_CORR there."""
    c, c_plain = np.asarray(c), np.asarray(c_plain)
    floor = np.where(c_plain >= MIN_CORR, MIN_CORR,
                     c_plain - PROD_MIN_SLACK)
    ok = c >= floor
    below = c < MIN_CORR
    print(f"{label} corr vs plain f64 on the card: min {c.min():.6f} "
          f"median {np.median(c):.6f} over {len(c)} samples (plain f32 "
          f"path: min {c_plain.min():.6f} median {np.median(c_plain):.6f}, "
          f"below {MIN_CORR} on {int((c_plain < MIN_CORR).sum())}); per "
          f"sample {fmt(c)}, plain f32 path {fmt(c_plain)}")
    if k_draws is not None:
        k_best = (np.max(k_draws, axis=0) if len(k_draws)
                  else np.full_like(c, -np.inf))
        if below.any():
            print(f"{label} samples {np.flatnonzero(below).tolist()} below "
                  f"{MIN_CORR}: kernel path {fmt(c[below])}, its best draw "
                  f"on the weights moved one f32 ulp {fmt(k_best[below])}")
        ok &= ~below | (k_best >= MIN_CORR)
    require(ok.all(), f"{label}: per-sample corr {fmt(c[~ok])} on samples "
            f"{np.flatnonzero(~ok).tolist()} below {fmt(floor[~ok])} or "
            f"not witnessed by the kernel path's moved draws")


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


# the training phases' gate, fixed before their first chip run: one
# float32 step's clipped gradients (ViT-B/16, B=32, exact FP32) against the
# same step in float64 on the card, same weights, by the relative 2-norm
# of all gradients together (float32 backprop on random weights lands near
# 1e-6; 1e-4 leaves room for softmax saturation without letting a wrong
# product through)
GRAD_REL_L2 = 1e-4
# the synthetic ERASER layout of the pipeline phase: documents of
# ERASER_DOC_WORDS words (wordpieces past 512, so every encoding truncates)
# from ERASER_WORDS, some of which split into two or three wordpieces
ERASER_SPLITS = {"train": 40, "val": 16, "test": 32}
ERASER_DOC_WORDS = 600
ERASER_WORDS = ("good", "bad", "movie", "plot", "actor", "the", "a", "was",
                "film", "scene", "story", "acting", "boring", "funny", "dull",
                "director", "music", "ending", "characters", "really", "not",
                "very", "and", "but", "it", "this", "is", "greatly",
                "unforgettable", "breathtaking", "cinematography")
ERASER_VOCAB = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "great",
                "##ly", "un", "##forget", "##table", "breath", "##taking",
                "cinema", "##tog", "##raphy") + tuple(
    w for w in ERASER_WORDS if w not in ("greatly", "unforgettable",
                                         "breathtaking", "cinematography"))


class WordpieceStandIn:
    """A tiny deterministic wordpiece tokenizer over a written vocab file:
    the two calls the ERASER pipeline makes of a tokenizer (``__call__``
    padded to ``max_length`` and ``convert_ids_to_tokens``), by BERT's
    greedy longest-match-first rule on lower-cased whitespace words, so
    the phase needs no ``transformers``."""

    def __init__(self, vocab_file):
        with open(vocab_file) as f:
            self.vocab = [line.rstrip("\n") for line in f]
        self.ids = {t: i for i, t in enumerate(self.vocab)}

    def _pieces(self, word):
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[
                    start:end]
                if piece in self.ids:
                    break
                end -= 1
            if end == start:
                return ["[UNK]"]
            out.append(piece)
            start = end
        return out

    def __call__(self, text, add_special_tokens=True, max_length=512,
                 truncation=True, padding="max_length",
                 return_token_type_ids=False, return_attention_mask=True):
        toks = [p for w in text.lower().split() for p in self._pieces(w)]
        toks = ["[CLS]"] + toks[:max_length - 2] + ["[SEP]"]
        ids = [self.ids[t] for t in toks]
        pad = max_length - len(ids)
        return {"input_ids": ids + [self.ids["[PAD]"]] * pad,
                "attention_mask": [1] * len(ids) + [0] * pad}

    def convert_ids_to_tokens(self, ids):
        return [self.vocab[i] for i in ids]


def training_phases(dev, tag, have, none):
    """Phase 4's training paths: the C7 check, the ViT-B/16 trainer and the
    ERASER pipeline on BERT-base. Returns the launch counts of each run
    (every count set to 0 before it, read after) for the kernels line."""
    import shutil
    import tempfile
    import torch
    from transformer_explainability_torch import train as tr
    from transformer_explainability_torch.explain import bert_generator as bg
    from transformer_explainability_torch.models import bert as bert_mod
    from transformer_explainability_torch.models import vit as vit_mod
    from transformer_explainability_torch.models.registry import create_model
    from transformer_explainability_torch.ops import kernels as K
    from transformer_explainability_torch.rationale import data as rdata
    from transformer_explainability_torch.rationale import metrics as rmetrics
    from transformer_explainability_torch.rationale import pipeline as rpl
    from transformer_explainability_torch.utils import checkpoint as ckpt

    launches = []
    t_phase = time.perf_counter()

    # C7: a seed is one model on every device
    sds = {}
    for name in ("vit_base_patch16_224", "bert-base-uncased"):
        _, on_card = create_model(name, seed=0, device=dev)
        _, on_cpu = create_model(name, seed=0, device="cpu")
        same = set(on_card) == set(on_cpu) and all(
            on_card[k].device.type == dev.type
            and torch.equal(on_card[k], on_cpu[k].to(dev)) for k in on_cpu)
        print(f"C7 {name}: create_model(seed=0) on the card bitwise the CPU "
              f"draw moved to the card: {same}")
        require(same, f"C7: {name} seed 0 differs between the card and the "
                f"CPU")
        sds[name] = on_cpu
        del on_card

    # the ViT-B/16 trainer at full width, B=32, a fixed seeded batch
    cfg = vit_mod.VIT_BASE_16_224
    truth = np.load(os.path.join(ROOT, "experiments/data/fidelity_truth.npz"))
    rng = np.random.RandomState(17)
    imgs = np.concatenate([truth["imgs"][:17], rng.randn(
        15, 3, 224, 224).astype(np.float32)])[:32]
    labels = rng.randint(0, cfg.num_classes, size=32)
    imgs_t = torch.as_tensor(imgs, device=dev)
    labels_t = torch.as_tensor(labels, device=dev)
    opt = tr.make_optimizer(lr=1e-4, weight_decay=0.05, max_grad_norm=1.0)
    step_ms = {}
    for mode in ("float32", "bfloat16"):
        model, state = tr.init_train_state(0, cfg, opt, device=dev)
        require(all(torch.equal(v, sds["vit_base_patch16_224"][k].to(dev))
                    for k, v in model.state_dict().items()),
                "init_train_state(0) is not create_model's seed-0 model")
        step = tr.make_train_step(cfg, opt, matmul_precision=mode)
        K.reset_launch_counts()
        losses, ev = [], []
        for i in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            _, _, loss = step(model, state, imgs_t, labels_t)
            e1.record()
            losses.append(loss.item())
            ev.append((e0, e1))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        launches.append(counts)
        require(counts == none, f"vit trainer {mode}: launches {counts}")
        step_ms[mode] = float(np.mean([a.elapsed_time(b) for a, b in ev[1:]]))
        print(f"vit trainer {mode} ViT-B/16 B=32: losses "
              f"{[round(x, 6) for x in losses]}; {step_ms[mode]:.2f} ms a "
              f"step (CUDA events, steps 2-5) {tag}")
        require(np.isfinite(losses).all() and losses[-1] < losses[0],
                f"vit trainer {mode}: losses {losses} not finite or not "
                f"falling")
        del model, state, step
        torch.cuda.empty_cache()

    # one float32 step's clipped gradients against float64, same weights
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = vit_mod.VisionTransformer(cfg, device=dev, dtype=dtype)
        m.load_state_dict({k: v.to(dtype) for k, v in
                           sds["vit_base_patch16_224"].items()})
        loss = tr.cross_entropy(vit_mod.train_forward(
            m, imgs_t.to(dtype), "float32"), labels_t)
        loss.backward()
        norm = tr.clip_by_global_norm(m.parameters(), 1.0)
        grads[dtype] = ([p.grad.double() for p in m.parameters()],
                        norm.item(), loss.item())
        del m, loss
    g32, n32, l32 = grads[torch.float32]
    g64, n64, l64 = grads[torch.float64]
    num = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(g32, g64)))
    den = torch.sqrt(sum((b ** 2).sum() for b in g64))
    rel = (num / den).item()
    worst = max(((a - b).norm() / b.norm()).item() for a, b in zip(g32, g64)
                if b.norm() > 0)
    print(f"vit trainer float32 step vs float64 on the card: loss "
          f"{l32:.8f} / {l64:.8f}, gradient norm before the clip "
          f"{n32:.6f} / {n64:.6f}, clipped gradients rel-L2 {rel:.3e} "
          f"(worst tensor {worst:.3e}; gate {GRAD_REL_L2})")
    require(rel <= GRAD_REL_L2, f"vit trainer: float32 gradients rel-L2 "
            f"{rel:.3e} from float64")
    del grads, g32, g64
    torch.cuda.empty_cache()

    # save / restore then one step == one uninterrupted step, bitwise
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_", dir=build)
    step = tr.make_train_step(cfg, opt, matmul_precision="float32")
    model, state = tr.init_train_state(0, cfg, opt, device=dev)
    step(model, state, imgs_t[:16], labels_t[:16])
    prefix = os.path.join(work, "state")
    ckpt.save_train_state(prefix, model, state, {"step": 1})
    _, _, loss_a = step(model, state, imgs_t[16:], labels_t[16:])
    model2 = vit_mod.VisionTransformer(cfg, device=dev)
    state2 = opt.init(model2)
    params, opt_sd, meta = ckpt.restore_train_state(prefix, model2, state2)
    model2.load_state_dict(params)
    state2.load_state_dict(opt_sd)
    _, _, loss_b = step(model2, state2, imgs_t[16:], labels_t[16:])
    same = torch.equal(loss_a, loss_b) and all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                          model2.state_dict().values()))
    print(f"vit trainer save/restore then one step bitwise one "
          f"uninterrupted step: {same} (meta {meta})")
    require(same and meta == {"step": 1}, "train-state round trip differs")
    del model, model2, state, state2, params, opt_sd, step
    torch.cuda.empty_cache()

    # the ERASER pipeline at BERT-base's full width on a synthetic layout
    bcfg = bert_mod.BERT_BASE_UNCASED
    data_dir = os.path.join(work, "eraser")
    os.makedirs(os.path.join(data_dir, "docs"))
    vocab_dir = os.path.join(work, "vocab")
    os.makedirs(vocab_dir)
    with open(os.path.join(vocab_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(ERASER_VOCAB) + "\n")
    tok = WordpieceStandIn(os.path.join(vocab_dir, "vocab.txt"))
    rng = np.random.RandomState(23)
    anns, i = {s: [] for s in ERASER_SPLITS}, 0
    for split, count in ERASER_SPLITS.items():
        for _ in range(count):
            words = [ERASER_WORDS[j] for j in rng.randint(
                len(ERASER_WORDS), size=ERASER_DOC_WORDS)]
            half = ERASER_DOC_WORDS // 2
            docid = f"doc_{i}"
            with open(os.path.join(data_dir, "docs", docid), "w") as f:
                f.write(" ".join(words[:half]) + "\n"
                        + " ".join(words[half:]))
            start = int(rng.randint(0, ERASER_DOC_WORDS - 10))
            ev = rdata.Evidence(text=" ".join(words[start:start + 8]),
                                docid=docid, start_token=start,
                                end_token=start + 8, start_sentence=0,
                                end_sentence=1)
            anns[split].append(rdata.Annotation(
                annotation_id=docid, query="what is the sentiment?",
                evidences=frozenset([(ev,)]),
                classification=("POS", "NEG")[i % 2]))
            i += 1
        rdata.annotations_to_jsonl(anns[split], os.path.join(
            data_dir, f"{split}.jsonl"))
    train, val, test = rdata.load_datasets(data_dir)
    documents = rdata.load_documents(data_dir)
    interned = rpl.intern_documents_bert(documents, tok, 512)
    lengths = [int(v["attention_mask"].sum()) for v in interned.values()]
    require(min(lengths) == 512, f"documents must truncate at 512: "
            f"{min(lengths)}")
    classes = {"NEG": 0, "POS": 1}
    out = os.path.join(work, "out")
    tkw = dict(batch_size=10, epochs=2, patience=10, lr=1e-5,
               max_grad_norm=1, dropout=0.1, seed=0, device=dev)
    bparams = sds["bert-base-uncased"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    best, res = rpl.train_classifier(bparams, bcfg, train, val, interned,
                                     classes, out, **tkw)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    counts = K.launch_counts()
    launches.append(counts)
    require(counts == none, f"pipeline training: launches {counts}")
    print(f"pipeline train_classifier BERT-base S=512 B=10, 2 epochs of "
          f"{len(train)}: {t_train:.2f} s; results {res}")
    require(len(res["train_loss"]) == 2 and np.isfinite(
        res["train_loss"] + res["val_loss"]).all(),
        f"pipeline training results {res}")
    again, res2 = rpl.train_classifier(bparams, bcfg, train, val, interned,
                                       classes, out, **tkw)
    resumed = res2 == res and all(torch.equal(again[k], best[k])
                                  for k in best)
    print(f"pipeline train_classifier rerun resumes as done: {resumed}")
    require(resumed, "pipeline: the rerun did not resume as done")
    del again
    # the step alone at B=10, S=512, exact FP32, dropout 0.1
    model = bert_mod.BertForSequenceClassification(bcfg, device=dev)
    model.load_state_dict(bparams)
    bopt = torch.optim.Adam(model.parameters(), lr=1e-5)
    bstep = rpl.make_train_step(bcfg, 1.0, 0.1)
    ids, mask, tgt = rpl._batch_arrays(train[:10], interned, classes)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = np.ones(len(tgt), np.float32)
    bert_step_ms = time_ms(lambda: bstep(model, bopt, ids, mask, tgt, w,
                                         gen), iters=5, warmup=2)
    print(f"pipeline train step BERT-base B=10 S=512 exact FP32 dropout "
          f"0.1: {bert_step_ms:.2f} ms (CUDA events) {tag}")
    del model, bopt, bstep
    torch.cuda.empty_cache()

    # the explain stage at float32 and bfloat16, every map recorded for
    # the gate (the recording subclass computes nothing of its own)
    captured = []

    class Recording(rpl.BertExplainer):
        def explain(self, input_ids, attention_mask, indices=None,
                    method="transformer_attribution", start_layer=11,
                    alpha=1.0):
            row = super().explain(input_ids, attention_mask, indices, method,
                                  start_layer, alpha)
            captured.append((np.asarray(input_ids),
                             np.asarray(attention_mask),
                             np.asarray(indices), start_layer, row.clone()))
            return row

    def tcorr(x, y, valid):
        c = []
        for a, b, v in zip(x.double(), y.double(), valid):
            a, b = a[v] - a[v].mean(), b[v] - b[v].mean()
            c.append(((a * b).sum() / (a.norm() * b.norm())).item())
        return c

    m64 = bert_mod.BertForSequenceClassification(bcfg, device=dev,
                                                 dtype=torch.float64)
    m64.load_state_dict({k: v.double() if v.is_floating_point() else v
                         for k, v in best.items()})
    m64.requires_grad_(False)
    m32 = bert_mod.BertForSequenceClassification(bcfg, device=dev)
    m32.load_state_dict(best)
    m32.requires_grad_(False)
    logits = rpl.make_eval_step(bcfg)(m32, *rpl._batch_arrays(
        test, interned, classes)[:2]).cpu().numpy()
    rates = {}
    real = rpl.BertExplainer
    rpl.BertExplainer = Recording
    try:
        for mode in ("float32", "bfloat16"):
            captured.clear()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            paths = rpl.explain_test_split(
                best, bcfg, test, interned, documents, classes, tok,
                os.path.join(out, mode), batch_size=10,
                matmul_precision=mode, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = K.launch_counts()
            launches.append(counts)
            calls = len(captured)
            n_expl = sum(len(c[0]) for c in captured)
            want = {**none, "rollout_from_grad_cam": calls}
            if mode == "bfloat16":
                want.update(bert_layer_fwd_core=12 * calls,
                            bert_out_rev_core=12 * calls,
                            bert_attn_rev_core=12 * calls)
            require(calls == 8 and counts == want,
                    f"pipeline explain {mode}: {calls} calls, launches "
                    f"{counts}")
            rates[mode] = n_expl / dt
            print(f"pipeline explain_test_split {mode}: {n_expl} maps "
                  f"({calls} calls, GT and CF) of {len(test)} test "
                  f"annotations in {dt:.2f} s = {rates[mode]:.2f} expl/s "
                  f"(files, LaTeX and host work included); launches "
                  f"{counts} {tag}")
            kw = rpl.explain_precision(mode)
            c, cp = [], []
            for ids_, mask_, idx_, sl, row in captured:
                ids_t = torch.as_tensor(ids_, device=dev).long()
                m_t = torch.as_tensor(mask_, device=dev)
                idx_t = torch.as_tensor(idx_, device=dev).long()
                ref = bg.explain_batch(m64, ids_t, m_t, idx_t, sl,
                                       ops=K.BERT_PLAIN_OPS, **kw)
                p32 = bg.explain_batch(m32, ids_t, m_t, idx_t, sl,
                                       ops=K.BERT_PLAIN_OPS, **kw)
                valid = m_t.bool()
                require(torch.isfinite(row).all().item(),
                        f"pipeline explain {mode}: non-finite map")
                c += tcorr(row, ref, valid)
                cp += tcorr(p32, ref, valid)
            # float32 by exact FP32's per-sample rule; bfloat16 by the
            # presets' gate against the plain float32 path
            if mode == "float32":
                sample_gate("pipeline explain float32", c, cp)
            else:
                preset_gate("pipeline explain bfloat16", c, [cp])
            # score the decoded rationales: the hard ones always; the soft
            # and the classification scores where scikit-learn imports
            for path in (paths[0], paths[-1]):
                rows = rdata.load_jsonl(path)
                k = int(path.rsplit("_", 1)[1].split(".")[0])
                require(len(rows) == len(test) and all(
                    len(r["rationales"][0]["hard_rationale_predictions"])
                    == k for r in rows), f"{path}: rows or spans")
            rows = rdata.load_jsonl(paths[1])
            hard = [{"annotation_id": r["annotation_id"], "rationales": [{
                "docid": r["rationales"][0]["docid"],
                "hard_rationale_predictions":
                    r["rationales"][0]["hard_rationale_predictions"]}]}
                for r in rows]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # sklearn's 0/0 notes
                scores = rmetrics.score_results(hard, test, data_dir)
            print(f"pipeline scores {mode} (top-10, hard only): token F1 "
                  f"{scores['token_prf']['instance_micro']['f1']:.4f}, "
                  f"IOU F1 {scores['iou_scores'][0]['micro']['f1']:.4f}")
            if have["sklearn"]:
                probs = np.exp(logits - logits.max(-1, keepdims=True))
                probs /= probs.sum(-1, keepdims=True)
                for r, p in zip(rows, probs):
                    r["classification"] = ("NEG", "POS")[int(p.argmax())]
                    r["classification_scores"] = {"NEG": float(p[0]),
                                                  "POS": float(p[1])}
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    full = rmetrics.score_results(rows, test, data_dir)
                print(f"pipeline scores {mode}: soft AUPRC "
                      f"{full['token_soft_metrics']['auprc']:.4f}, "
                      f"accuracy {full['classification_scores']['accuracy']}"
                      f" (scikit-learn present: hard, soft and "
                      f"classification scores ran)")
            else:
                print(f"pipeline scores {mode}: scikit-learn absent: the "
                      f"hard scores ran, the soft and classification scores "
                      f"did not")
    finally:
        rpl.BertExplainer = real
    del m64, m32, captured
    torch.cuda.empty_cache()

    # run_pipeline itself where transformers imports, on the written vocab
    if have["transformers"]:
        from transformers import BertTokenizerFast
        fast = BertTokenizerFast.from_pretrained(vocab_dir)
        doc = documents[test[0].annotation_id]
        same = (fast(doc, max_length=512, truncation=True,
                     padding="max_length")["input_ids"]
                == tok(doc)["input_ids"])
        print(f"transformers BertTokenizerFast on the written vocab gives "
              f"the stand-in's ids: {same}")
        require(same, "the wordpiece stand-in differs from BertTokenizerFast")
        mp = {"max_length": 512, "bert_vocab": vocab_dir,
              "evidence_classifier": {"classes": ["NEG", "POS"],
                                      "batch_size": 10, "epochs": 1,
                                      "patience": 10, "lr": 1e-5,
                                      "max_grad_norm": 1}}
        K.reset_launch_counts()
        t0 = time.perf_counter()
        _, rres, rpaths = rpl.run_pipeline(data_dir, os.path.join(work, "run"),
                                           mp, seed=0, device=dev)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        launches.append(counts)
        rows = rdata.load_jsonl(rpaths[0])
        print(f"run_pipeline (transformers tokenizer, 1 epoch, float32 "
              f"explain): {time.perf_counter() - t0:.2f} s, results {rres}, "
              f"{len(rows)} rows, launches {counts}")
        require(len(rows) == len(test) and counts == {
            **none, "rollout_from_grad_cam": 8}, "run_pipeline")
    else:
        print("run_pipeline: transformers absent, not run (the stages ran "
              "with the wordpiece stand-in)")
    shutil.rmtree(work, ignore_errors=True)
    print(f"training phases: {time.perf_counter() - t_phase:.1f} s; vit "
          f"train step float32 {step_ms['float32']:.2f} ms, bfloat16 "
          f"{step_ms['bfloat16']:.2f} ms; BERT pipeline step "
          f"{bert_step_ms:.2f} ms; explain stage float32 "
          f"{rates['float32']:.2f} expl/s, bfloat16 {rates['bfloat16']:.2f} "
          f"expl/s {tag}")
    return launches


# the reduced-base phase (A3a): the ViT methods off the kernel branch and
# BERT's plain layers at the bfloat16 and production presets, and the
# precision islands. Each pair runs through the user's entry points on the
# first REDUCED_DEPTH blocks (BERT: layers) of the seeded weights,
# embeddings and head unchanged (launches, the gate, fidelity, rates): the
# gate's CPU side at 12 took 450-650 s, most of a script that overran its
# 1200 s on a slower host, and the printed fidelity and rates at 12 blocks
# were 290-493 s of a script near its limit, so they too run at
# REDUCED_DEPTH. The gate's float32 maps on the card are held
# by preset_gate (witnessed) on REDUCED_SAMPLES samples against the same
# port path in float64 on the card: its plain draws are that path in
# float32 on the card machine's CPU, on the weights as they are and on
# REDUCED_DRAWS sets moved one float32 ulp (seeds REDUCED_SEED + 1, ...),
# its witnesses the card's path on REDUCED_WITNESSES other moved sets
# (seeds REDUCED_SEED + 101, ...). The float64 path on the card is held to
# the CPU's on the first TWIN_SAMPLES of those samples: 1 - corr <=
# TWIN_GAP (the same bf16 and bf16x3 roundings of the same operands, only
# the summation order differs: <= 6.7e-16 on an H100; one product in
# another mode moves it by 1e-4 or more)
REDUCED_DEPTH = 4
REDUCED_SAMPLES = 4
REDUCED_DRAWS = 2
REDUCED_WITNESSES = 8
REDUCED_SEED = 1800
TWIN_SAMPLES = 2
TWIN_GAP = 1e-12
REDUCED_PRESETS = ("bfloat16", "production")
# the fidelity printed beside each pair: corr against the port's exact path
# in float64 on the card; a sample below FIDELITY_TAIL is counted
FIDELITY_TAIL = 0.99
_BLOCK_KEY = re.compile(r"^(?:blocks|bert\.encoder\.layer)\.(\d+)\.")


def first_blocks(sd, depth):
    """A ViT or BERT state dict cut to its first ``depth`` blocks
    (layers)."""
    return {k: v for k, v in sd.items()
            if not ((m := _BLOCK_KEY.match(k)) and int(m.group(1)) >= depth)}


def reduced_base_phase(dev, tag, none, params, batches, bparams,
                       bert_batches, drive, corr, token_corr, ulp_moved):
    """Drive each (method, preset) pair of the reduced bases through the
    user's entry points on the card (B = 8; BERT-base at S = 512) on the
    first REDUCED_DEPTH blocks of the weights, gate its float32 maps
    against the same path's on the CPU and the same path in float64 on the
    card against the CPU's, print the maps' fidelity against the exact
    float64 path beside exact FP32's and their rate, all at that depth;
    return the launch counts of the card runs. ``ulp_moved(sd, seed)``
    moves a float32 state dict on the card one ulp (seeded)."""
    import torch
    from transformer_explainability_torch.explain import (BertExplainer,
                                                          Explainer)
    from transformer_explainability_torch.explain import bert_generator as bg
    from transformer_explainability_torch.explain.generator import (
        METHODS, explain_batch, precision_kwargs)
    from transformer_explainability_torch.models import bert as bert_mod
    from transformer_explainability_torch.models.vit import (
        VIT_BASE_16_224, VisionTransformer)
    from transformer_explainability_torch.ops import kernels as K
    t_phase = time.perf_counter()
    cfg, bcfg = VIT_BASE_16_224, bert_mod.BERT_BASE_UNCASED
    gcfg = dataclasses.replace(cfg, depth=REDUCED_DEPTH)
    gbcfg = dataclasses.replace(bcfg, num_layers=REDUCED_DEPTH)
    gparams = first_blocks(params, REDUCED_DEPTH)
    gbparams = first_blocks(bparams, REDUCED_DEPTH)
    L = REDUCED_DEPTH
    cpu = torch.device("cpu")

    def f64(sd, device):
        return {k: v.to(device=device, dtype=torch.float64)
                if v.is_floating_point() else v.to(device)
                for k, v in sd.items()}

    vit_off = [m for m in METHODS if m not in ("transformer_attribution",
                                               "grad")]
    island_above = dict(matmul_precision="bfloat16",
                        relprop_precision="float32")
    island_f32 = dict(matmul_precision="float32", attn_precision="bfloat16",
                      relprop_precision="bfloat16")
    # (label, explainer kwargs, call kwargs, launches a batch beyond none)
    vit_runs = []
    for preset in REDUCED_PRESETS:
        for m in vit_off:
            per = ({"rollout_from_grad_cam": 1}
                   if m in ("rollout", "rollout_attn") else {})
            vit_runs.append((f"{m} {preset}", precision_kwargs(preset),
                             dict(method=m), per))
    b1 = {"rollout_from_grad_cam": 1}
    vit_runs += [
        ("transformer_attribution lrp production",
         dict(precision_kwargs("production"), variant="lrp"), {}, b1),
        ("transformer_attribution alpha=2 production",
         precision_kwargs("production"), dict(alpha=2.0), b1),
        ("transformer_attribution bfloat16 base, float32 rules",
         island_above, {}, b1),
        ("transformer_attribution float32 base, bfloat16 attention and "
         "rules", island_f32, {},
         dict(b1, attn_fwd_core=L, attn_rev_core=L))]
    bert_runs = [(f"{m} {preset}", precision_kwargs(preset),
                  dict(method=m, start_layer=0) if m == "rollout"
                  else dict(method=m), {})
                 for preset in REDUCED_PRESETS
                 for m in bg.METHODS if m != "transformer_attribution"]

    launches, rows = [], []
    sd64 = {dev_: f64(gparams, dev_) for dev_ in (cpu, dev)}
    bsd64 = {dev_: f64(gbparams, dev_) for dev_ in (cpu, dev)}
    vit64 = VisionTransformer(gcfg, device=dev, dtype=torch.float64)
    vit64.load_state_dict({k: v.double() for k, v in gparams.items()})
    vit64.requires_grad_(False)
    bert64 = bert_mod.BertForSequenceClassification(gbcfg, device=dev,
                                                    dtype=torch.float64)
    bert64.load_state_dict({k: v.double() if v.is_floating_point() else v
                            for k, v in gbparams.items()})
    bert64.requires_grad_(False)
    truths = {}
    # the gate's weights, per model: the plain draws' on the CPU (as they
    # are, then moved), the witnesses' on the card; and the gate's
    # explainers on them and on the float64 weights for the current
    # explainer kwargs
    weights, draw_ex = {}, {}
    print(f"reduced-base phase gate: per (method, preset), on the first "
          f"{REDUCED_DEPTH} blocks (layers) of the weights, the card's "
          f"float32 maps on {REDUCED_SAMPLES} samples against the same path "
          f"in float64 on the card, by preset_gate (witnessed): the plain "
          f"draws that path in float32 on the CPU (the weights as they are "
          f"and {REDUCED_DRAWS} sets moved one f32 ulp), the witnesses the "
          f"card's path on {REDUCED_WITNESSES} other moved sets; the float64 "
          f"path on the card against the CPU's on {TWIN_SAMPLES} samples, "
          f"1 - corr <= {TWIN_GAP:.0e}; fidelity against the exact float64 "
          f"path on the card and rates printed, not gated, at the same depth "
          f"{tag}")

    def pair(bert, label, ekw, ckw, per):
        name = "bert" if bert else "vit"
        variant = ekw.get("variant", "ours")
        method = ckw.get("method", "transformer_attribution")
        cls = BertExplainer if bert else Explainer
        gsd32 = gbparams if bert else gparams
        gate_cfg = gbcfg if bert else gcfg

        def make_gate(sd, device, **kw):
            return cls(sd, gate_cfg, device, **kw)

        if bert:
            shape = (8, 512)
        else:
            shape = {"full": (8, cfg.img_size, cfg.img_size),
                     "attn_gradcam": (8, cfg.grid, cfg.grid)}.get(
                         method, (8, cfg.num_patches))
        if name not in weights:
            weights.clear()
            weights[name] = (
                [{k: v.to(cpu) for k, v in sd.items()} for sd in
                 [gsd32] + [ulp_moved(gsd32, REDUCED_SEED + j)
                            for j in range(1, REDUCED_DRAWS + 1)]],
                [ulp_moved(gsd32, REDUCED_SEED + 100 + j)
                 for j in range(1, REDUCED_WITNESSES + 1)])
        ekey = (name, tuple(sorted(ekw.items())))
        if ekey not in draw_ex:
            draw_ex.clear()
            plain_sd, wit_sd = weights[name]
            sd64_ = bsd64 if bert else sd64
            draw_ex[ekey] = ([make_gate(sd, "cpu", **ekw) for sd in plain_sd],
                             [make_gate(sd, "cuda", **ekw) for sd in wit_sd],
                             make_gate(sd64_[cpu], "cpu", **ekw),
                             make_gate(sd64_[dev], "cuda", **ekw),
                             make_gate(gsd32, "cuda", **ekw))
        plain_ex, wit_ex, twin_ex, card64_ex, gate_ex = draw_ex[ekey]

        def run(ex, b, rows_=slice(None), kw=ckw):
            """``ex`` on batch ``b`` (the samples ``rows_``)."""
            if bert:
                ids, valid, idx = bert_batches[b]
                return ex.explain(ids[rows_], valid[rows_], idx[rows_], **kw)
            imgs, idx = batches[b]
            return ex.explain(imgs[rows_], idx[rows_], **kw)

        def sim(x, y, b, rows_):
            """Per-sample corr of maps ``x`` and ``y`` of batch ``b``'s
            samples ``rows_`` (BERT: over each sample's tokens), on the
            CPU."""
            x, y = x.to(cpu), y.to(cpu)
            if bert:
                valid = torch.as_tensor(bert_batches[b][1][rows_]).bool()
                return np.asarray(token_corr(x, y, valid))
            return np.asarray(corr(x.reshape(len(x), -1),
                                   y.reshape(len(y), -1)))

        def finite(x):
            return torch.isfinite(x.reshape(8, -1)).all(dim=1).cpu()

        # the gate's batch: the first with REDUCED_SAMPLES finite samples of
        # the gate's float64 path on the card (attn_gradcam is 0/0 on a map
        # with no positive entry, as in JAX)
        for gb in range(len(batches)):
            card64 = run(card64_ex, gb)
            gfin = finite(card64)
            if int(gfin.sum()) >= REDUCED_SAMPLES:
                break
        sel = np.flatnonzero(gfin.numpy())[:REDUCED_SAMPLES]
        require(len(sel) == REDUCED_SAMPLES,
                f"reduced {name} {label}: {len(sel)} finite samples of the "
                f"gate's float64 path")
        card64 = card64[sel]
        # the CPU's runs (the same path in float64 on the first
        # TWIN_SAMPLES samples, the twin; the plain draws) beside the card's
        # untimed ones; the rates are timed after both
        twin = sel[:TWIN_SAMPLES]
        cpu_side = {}

        def on_cpu():
            try:
                t0 = time.perf_counter()
                cpu_side["twin"] = run(twin_ex, gb, twin)
                cpu_side["twin_s"] = time.perf_counter() - t0
                cpu_side["plain"] = [run(e, gb, sel) for e in plain_ex]
                cpu_side["draws_s"] = time.perf_counter() - t0 - cpu_side[
                    "twin_s"]
            except BaseException as e:       # re-raised by the main thread
                cpu_side["error"] = e

        worker = threading.Thread(target=on_cpu)
        worker.start()
        try:
            # the exact float64 path on the card (the truth) and exact
            # FP32's card path, once per method, variant, alpha and batch;
            # the batch is the first with REDUCED_SAMPLES finite truths
            for b in range(len(batches)):
                key = (name, variant, tuple(sorted(ckw.items())), b)
                if key not in truths:
                    ex32 = make_gate(gsd32, "cuda", variant=variant)
                    if bert:
                        ids_t, m_t, idx_t = (torch.as_tensor(a, device=dev)
                                             for a in bert_batches[b])
                        truth = bg.explain_batch(bert64, ids_t, m_t, idx_t,
                                                 variant=variant,
                                                 ops=K.BERT_PLAIN_OPS, **ckw)
                    else:
                        imgs, idx = batches[b]
                        truth = explain_batch(
                            vit64, torch.as_tensor(imgs, device=dev,
                                                   dtype=torch.float64),
                            torch.as_tensor(idx, device=dev),
                            variant=variant, ops=K.PLAIN_OPS, **ckw)
                    truths[key] = (truth, run(ex32, b), ex32)
                truth, heat32, ex32 = truths[key]
                fin = finite(truth)
                if int(fin.sum()) >= REDUCED_SAMPLES:
                    break
            every = np.flatnonzero(fin.numpy())
            ex = gate_ex
            (heat,), counts = drive(lambda: run(ex, b), [()], shape,
                                    {**none, **per}, f"reduced {name} {label}",
                                    finite=method != "attn_gradcam")
            launches.append(counts)
            require(torch.equal(finite(heat), fin),
                    f"reduced {name} {label}: finite samples differ from the "
                    f"float64 path's")
            fid = sim(heat[every], truth[every], b, every)
            fid32 = sim(heat32[every], truth[every], b, every)
            gheat = run(gate_ex, gb)
            require(torch.equal(finite(gheat), gfin),
                    f"reduced {name} {label}: the gate's finite samples "
                    f"differ from its float64 path's")
            wit = [run(e, gb)[sel] for e in wit_ex]
        finally:
            worker.join()
        if "error" in cpu_side:
            raise cpu_side["error"]
        cpu_s, draws_s = cpu_side["twin_s"], cpu_side["draws_s"]
        gap = 1 - sim(card64[:TWIN_SAMPLES], cpu_side["twin"], gb, twin)
        require(float(gap.max()) <= TWIN_GAP, f"reduced {name} {label}: "
                f"the float64 path, card vs CPU: 1 - corr {fmt(gap)} above "
                f"{TWIN_GAP:.0e}")
        # the gate: the card's float32 maps, the CPU's float32 draws and the
        # card's witnesses against that float64 path
        c_plain = [sim(x, card64, gb, sel) for x in cpu_side["plain"]]
        c_wit = [sim(x, card64, gb, sel) for x in wit]
        c = sim(gheat[sel], card64, gb, sel)
        preset_gate(f"reduced {name} {label}", c, c_plain, c_wit,
                    witnessed=True)
        ms = time_ms(lambda: run(ex, b), iters=3, warmup=1)
        ms32 = time_ms(lambda: run(ex32, b), iters=3, warmup=1)
        row = dict(model=name, pair=label, gate_depth=REDUCED_DEPTH,
                   gate_batch=gb, samples=sel.tolist(),
                   card_vs_f64=c.tolist(),
                   cpu_draws_vs_f64=[p.tolist() for p in c_plain],
                   witnesses_vs_f64=[k.tolist() for k in c_wit],
                   twin_gap=gap.tolist(), batch=b,
                   fid_median=float(np.median(fid)), fid_min=float(fid.min()),
                   fid_below=int((fid < FIDELITY_TAIL).sum()),
                   n=len(fid), f32_median=float(np.median(fid32)),
                   f32_min=float(fid32.min()),
                   f32_below=int((fid32 < FIDELITY_TAIL).sum()),
                   expl_s=8000.0 / ms, f32_expl_s=8000.0 / ms32,
                   cpu_twin_s=cpu_s, cpu_draws_s=draws_s)
        rows.append(row)
        print(f"reduced {name} {label}: the float64 path card vs CPU 1 - "
              f"corr {fmt(gap)} (CPU {cpu_s:.1f} s); the float32 maps vs "
              f"that path at depth {REDUCED_DEPTH} on samples {sel.tolist()} "
              f"(batch {gb}): card {fmt(c)}, CPU as they are "
              f"{fmt(c_plain[0])} (the CPU's draws {draws_s:.1f} s); "
              f"fidelity of the float32 maps vs exact f64 on the card "
              f"median {row['fid_median']:.6f} min {row['fid_min']:.6f}, "
              f"{row['fid_below']} of {row['n']} below {FIDELITY_TAIL} "
              f"(exact FP32: median {row['f32_median']:.6f} min "
              f"{row['f32_min']:.6f}, {row['f32_below']} below); "
              f"{row['expl_s']:.1f} expl/s (exact FP32 "
              f"{row['f32_expl_s']:.1f}) at B=8 {tag}")
        del ex
        torch.cuda.empty_cache()

    for label, ekw, ckw, per in vit_runs:
        pair(False, label, ekw, ckw, per)
    for label, ekw, ckw, per in bert_runs:
        pair(True, label, ekw, ckw, per)
    weights.clear()
    draw_ex.clear()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "reduced_bases.json"), "w") as f:
        json.dump(dict(card=card_line(), rows=rows), f, indent=1)
    print(f"reduced-base phase: {len(rows)} pairs in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# the bf16×3 ("tensorfloat32") instances of B2-B5 (A3b). B5's (attention,
# rule) pairs with a bf16×3 product (with the four that predate them, the
# nine the float32 base's islands reach); the block presets (mxu, attn_mxu,
# rule_mxu, mlp_mxu) that reach B2's bf16×3 attention core and B3's four
# new pairs: raw tensorfloat32 (B3 bf16×3 / bf16×3), the bfloat16 base
# with a tensorfloat32 attention island (bf16×3 / bf16) and the
# tensorfloat32 base with a float32 or bfloat16 attention island (float32
# or bf16 / bf16×3)
TF32 = "tensorfloat32"
TF32_B5_PAIRS = (("float32", TF32), ("bfloat16", TF32), (TF32, TF32),
                 (TF32, "float32"), (TF32, "bfloat16"))
TF32_BLOCK_MODES = {"tensorfloat32": (TF32, TF32, TF32, None),
                    "bf16-tf32-attn": ("bfloat16", TF32, "bfloat16", None),
                    "tf32-f32-attn": (TF32, "float32", TF32, None),
                    "tf32-bf16-attn": (TF32, "bfloat16", TF32, None)}
# the float32 checks of the new instances hold the kernel as one more
# float32 draw: its error against the float64 plain version may be
# F32_FACTOR times the largest of the plain float32 version's on the inputs
# as they are and on DRAWS copies with every element moved one float32 ulp
# (seeded), plus F32_FLOOR of the output's magnitude. An operand one ulp
# from a bf16 tie (the mixed pairs' bf16 rule products) or an
# ill-conditioned divide makes any one float32 run a draw (C4): on the
# emulator B5's bf16×3 outputs at n = 133 ran 3-60 times the plain float32
# version's error as it is, and inside its draws'
DRAWS = 4
# C5 (step 0 of A3b): B6's Rm, the output that missed the 2-norm rule at
# ViT-L widths, over C5_SEEDS draws of the inputs in each (MLP, rule) pair,
# beside the plain float32 version on DRAWS ulp-moved copies of each draw
# (repaired in csrc/gemm.cuh: the bf16x3 MLP products' chains are summed a
# k-step at a time, kBf16x3Rn)
C5_SEEDS = 16
C5_PAIRS = {"tf32/bf16": (TF32, "bfloat16"), "tf32/tf32": (TF32, TF32)}


def ulp_moved_tensor(t, gen):
    """``t`` with every element moved one float32 ulp up or down at random
    (``gen`` on ``t``'s device)."""
    import torch
    inf = torch.tensor(float("inf"), device=t.device)
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    return torch.where(up, torch.nextafter(t, inf), torch.nextafter(t, -inf))


def drawn_f32_rule(label, k32, plain, args32, p64, names, seed):
    """The new instances' float32 rule (DRAWS): ``k32`` the kernel's float32
    outputs, ``p64`` the plain float64 version's, ``plain(*a)`` the plain
    version on float32 tensors ``a`` (``args32`` as they are, then moved).
    Returns the largest |kernel - plain float32| over the outputs."""
    import torch
    gen = torch.Generator(device=args32[0].device).manual_seed(seed)
    draws = [plain(*args32)] + [
        plain(*(ulp_moved_tensor(t, gen) for t in args32))
        for _ in range(DRAWS)]
    e_max = 0.0
    for i, name in enumerate(names):
        k, w = k32[i], p64[i]
        require(torch.isfinite(k).all().item(),
                f"{label}[{name}]: non-finite float32 output")
        ek = (k.double() - w).abs().max().item()
        eps = [(d[i].double() - w).abs().max().item() for d in draws]
        lim = F32_FACTOR * max(eps) + F32_FLOOR * w.abs().max().item()
        e32 = (k - draws[0][i]).abs().max().item()
        e_max = max(e_max, e32)
        print(f"check {label}[{name}]: f32 max|k-p|={e32:.3e}, "
              f"max|k32-p64|={ek:.3e} <= {lim:.3e} (plain f32 as it is "
              f"{eps[0]:.3e}, on {DRAWS} ulp-moved draws up to "
              f"{max(eps[1:]):.3e})")
        require(ek <= lim, f"{label}[{name}]: float32 kernel error {ek:.3e} "
                f"above {lim:.3e}")
    return e_max


def tf32_kernel_checks(dev, K, bm, prec, shapes):
    """Phase 3's checks of the bf16×3 instances: B4 and B5 (every pair of
    TF32_B5_PAIRS) in float64 (rtol 1e-9) and float32 (drawn_f32_rule, B4
    by the F32 rule with one bf16×3 re-rounding, 2⁻¹⁶·max|v|, allowed) at
    each of ``shapes`` {name: (B, n, h, hd)}, and at n = 577 in float32
    where the instance fits a block (bf16 rules do not, C6; float64 does
    not); B2 and B3 in TF32_BLOCK_MODES at those shapes (float32); B5's P
    bitwise B2's probs from B2's own qkv in bf16×3 attention. Returns
    (the largest float32 |kernel - plain| at "main" of each wrapper, the
    float32 inputs of each main-shape call for phase 5's timings)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(1901)

    def randn(*shape, offset=0.0):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64) + offset

    errs, inputs = {}, {}

    def note(name, sname, e):
        if sname == "main":
            errs[name] = max(errs.get(name, 0.0), e)

    def counted(kern, *args, **kw):
        before = kern.launches
        out = kern(*args, **kw)
        torch.cuda.synchronize()
        require(kern.launches == before + 1,
                f"{kern.__name__}: launch count did not rise")
        return out

    def attn(sname, shp, f64=True):
        b, n, h, hd = shp
        scale = hd ** -0.5
        qkv = randn(b, n, 3 * h * hd, offset=1.0)
        g_o, cam_o = randn(b, n, h * hd), randn(b, n, h * hd)
        label = f"{sname} {tuple(shp)}"
        # B4
        k32 = counted(K.attn_fwd_core, qkv.float(), h, hd, scale, mxu=TF32)
        p64 = K.attn_fwd_core_plain(qkv, h, hd, scale, TF32)
        if f64:
            k64 = counted(K.attn_fwd_core, qkv, h, hd, scale, mxu=TF32)
            e64 = (k64 - p64).abs().max().item()
            require(torch.allclose(k64, p64, rtol=F64_RTOL, atol=F64_ATOL),
                    f"attn_fwd_core tf32 {label}: float64 kernel differs "
                    f"from plain by {e64:.3e}")
        p32 = K.attn_fwd_core_plain(qkv.float(), h, hd, scale, TF32)
        ek = (k32.double() - p64).abs().max().item()
        ep = (p32.double() - p64).abs().max().item()
        v_max = qkv[..., 2 * h * hd:].abs().max().item()
        lim = (F32_FACTOR * ep + F32_FLOOR * p64.abs().max().item()
               + 2.0 ** -16 * v_max)
        e32 = (k32 - p32).abs().max().item()
        print(f"check attn_fwd_core tensorfloat32 {label}: f64 "
              f"{'max|k-p|=%.3e' % e64 if f64 else 'not checked'}; f32 "
              f"max|k-p|={e32:.3e}, max|k32-p64|={ek:.3e} <= {lim:.3e} "
              f"(plain f32 {ep:.3e})")
        require(ek <= lim, f"attn_fwd_core tf32 {label}: float32 kernel "
                f"error {ek:.3e} above {lim:.3e}")
        note("attn_fwd_core", sname, e32)
        if sname == "main":
            inputs["attn_fwd_core"] = (qkv.float(), h, hd, scale)
        # B5, every pair with a bf16x3 product
        for a, r in TF32_B5_PAIRS if f64 else ((TF32, TF32),
                                                (TF32, "float32")):
            kw = dict(attn_mxu=a, rule_mxu=r)
            args32 = tuple(t.float() for t in (qkv, g_o, cam_o))
            k32 = counted(K.attn_rev_core, *args32, h, hd, scale, **kw)
            p64 = K.attn_rev_core_plain(qkv, g_o, cam_o, h, hd, scale, **kw)
            names = ["g_qkv", "cam_qkv", "gc"]
            if f64:
                k64 = counted(K.attn_rev_core, qkv, g_o, cam_o, h, hd, scale,
                              **kw)
                for nm, x, y in zip(names, k64, p64):
                    e = (x - y).abs().max().item()
                    print(f"check attn_rev_core {a}/{r} {label}[{nm}]: f64 "
                          f"max|k-p|={e:.3e}")
                    require(torch.allclose(x, y, rtol=F64_RTOL,
                                           atol=F64_ATOL),
                            f"attn_rev_core {a}/{r} {label}[{nm}]: float64 "
                            f"kernel differs from plain by {e:.3e}")
            e = drawn_f32_rule(
                f"attn_rev_core {a}/{r} {label}", k32,
                lambda *x, kw=kw: K.attn_rev_core_plain(*x, h, hd, scale,
                                                        **kw),
                args32, p64, names, 1902)
            note("attn_rev_core", sname, e)
            if sname == "main" and a == r == TF32:
                inputs["attn_rev_core"] = (*args32, h, hd, scale)

    def block_case(b, n, h, hd, base):
        D, M = h * hd, 4 * h * hd
        ws = [prec.prepare_weight(randn(o, i) / i ** 0.5, base)
              for o, i in ((3 * D, D), (D, D), (M, D), (D, M))]
        vecs = [1.0 + 0.1 * randn(D), 0.1 * randn(D), 1.0 + 0.1 * randn(D),
                0.1 * randn(D), 0.1 * randn(3 * D), 0.1 * randn(D),
                0.1 * randn(M), 0.1 * randn(D)]
        return (bm.BlockParams(*vecs, *ws),
                bm.BlockParams(*[v.float() for v in vecs], *ws),
                randn(b, n, D, offset=0.5), randn(b, n, D), randn(b, n, D))

    def block(preset, sname, shp):
        mxu, attn_m, rule, mlp = TF32_BLOCK_MODES[preset]
        b, n, h, hd = shp
        p64, p32, x, g_out, R = block_case(b, n, h, hd, mxu)
        eps = 1e-6
        fargs = (h, hd, eps, mxu, attn_m, mlp, True, True)
        label = f"{preset} {sname} {tuple(shp)}"
        k32 = counted(K.block_fwd_core, x.float(), p32, *fargs)
        f64 = bm.block_fwd_core_plain(x, p64, *fargs)
        f32 = bm.block_fwd_core_plain(x.float(), p32, *fargs)
        names = ["x_out", "x_mid", "out_m", "qkv_pre", "proj_pre", "dots",
                 "probs", "fc1_pre", "fc2_pre"]
        for i, nm in enumerate(names):
            ek = (k32[i].double() - f64[i]).abs().max().item()
            ep = (f32[i].double() - f64[i]).abs().max().item()
            lim = F32_FACTOR * ep + F32_FLOOR * f64[i].abs().max().item()
            e32 = (k32[i] - f32[i]).abs().max().item()
            print(f"check block_fwd_core[{nm}] {label}: f32 max|k-p|="
                  f"{e32:.3e}, max|k32-p64|={ek:.3e} <= {lim:.3e} (plain "
                  f"f32 {ep:.3e})")
            require(torch.isfinite(k32[i]).all().item() and ek <= lim,
                    f"block_fwd_core[{nm}] {label}: float32 kernel error "
                    f"{ek:.3e} above {lim:.3e}")
            if attn_m == TF32:
                note("block_fwd_core", sname, e32)
        # the reverse from the float64 forward's own anchors
        a64 = (x, f64[1], f64[2], g_out, R)
        a32 = tuple(t.float() for t in a64)
        s64, s32 = f64[3:], tuple(t.float() for t in f64[3:])
        rargs = (h, hd, eps, mxu, attn_m, rule, mlp)
        k32 = counted(K.block_rev_core, *a32, p32, *rargs, saved=s32)
        r64 = bm.block_rev_core_plain(*a64, p64, *rargs, saved=s64)
        e = drawn_f32_rule(
            f"block_rev_core {label}", k32,
            lambda *t: bm.block_rev_core_plain(*t[:5], p32, *rargs,
                                               saved=t[5:]),
            a32 + s32, r64, ["g_in", "R_in", "gc"], 1903)
        note("block_rev_core", sname, e)
        if sname == "main" and preset == "tensorfloat32":
            inputs["block_fwd_core"] = (x.float(), p32, *fargs)
            inputs["block_rev_core"] = (a32, p32, rargs, s32)

    for sname, shp in shapes.items():
        attn(sname, shp)
        for preset in TF32_BLOCK_MODES:
            block(preset, sname, shp)
        torch.cuda.empty_cache()
    attn("n=577", (8, 577, *shapes["main"][2:]), f64=False)
    # B5's P from B2's own qkv in bf16x3 attention: bitwise B2's probs (a
    # direct call of B5's C entry, which keeps its scratch maps; not
    # counted)
    from transformer_explainability_torch.ops import _build
    lib = _build.load_library()
    b, n, h, hd = shapes["main"]
    mxu, attn_m, rule, mlp = TF32_BLOCK_MODES["tensorfloat32"]
    _, p32, x, _, _ = block_case(b, n, h, hd, mxu)
    fwd = K.block_fwd_core(x.float(), p32, h, hd, 1e-6, mxu, attn_m, mlp,
                           save_attn=True)
    qkv = fwd[3] + p32.bqkv
    g_o, cam_o = (randn(b, n, h * hd).float() for _ in range(2))
    outs = [torch.empty_like(qkv), torch.empty_like(qkv),
            torch.empty(b, n, n, device=dev)]
    maps = [torch.empty(b, h, n, n, device=dev) for _ in range(4)]
    S1 = torch.empty(b, h, n, hd, device=dev)
    code = lib.te_attn_rev_f32(
        *[t.data_ptr() for t in (qkv, g_o, cam_o, *outs, *maps, S1)], b, n,
        h, hd, hd ** -0.5, K._ATTN_MODE[attn_m], K._ATTN_MODE[rule],
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    require(code == 0, f"attn_rev_core C entry failed ({code})")
    same = torch.equal(maps[0].view(torch.int32),
                       fwd[6].view(b, h, n, n).view(torch.int32))
    print(f"check B5's P vs B2's probs tensorfloat32 {(b, n, h, hd)}: "
          f"{'bitwise equal' if same else 'DIFFER'}")
    require(same, "B5's probabilities are not bitwise B2's (tensorfloat32)")
    return errs, inputs


def c5_measurement(dev, K, bm, prec, shapes):
    """C5: B6's Rm against its plain version by the 2-norm rule (|k32 -
    p64| / |p64| <= F32_FACTOR · the plain float32 version's + F32_FLOOR)
    over C5_SEEDS draws of the inputs, at each of ``shapes`` {name: (B, n,
    D, M)} and in each C5_PAIRS pair; beside it, the same rule applied to
    the plain float32 version on DRAWS ulp-moved copies of each draw's
    inputs (each a float32 implementation of the same function). Prints a
    line per draw and a summary per (shape, pair); returns {(shape, pair):
    (kernel misses, plain-draw misses, plain draws)}. Its inputs are made
    as phase 3's B6 check makes them. B3's MLP half is this code
    (csrc/mlp_rev.cuh)."""
    import torch
    out = {}
    eps = 1e-6
    for sname, (b, n, D, M) in shapes.items():
        for pname, (mlp, rule) in C5_PAIRS.items():
            k_miss = p_miss = 0
            ratios = []
            for seed in range(C5_SEEDS):
                gen = torch.Generator(device=dev).manual_seed(2000 + seed)

                def randn(*shape):
                    return torch.randn(*shape, generator=gen, device=dev,
                                       dtype=torch.float64)

                w1 = prec.prepare_weight(randn(M, D) / D ** 0.5, mlp)
                w2 = prec.prepare_weight(randn(D, M) / M ** 0.5, mlp)
                vecs = (1.0 + 0.1 * randn(D), 0.1 * randn(D), 0.1 * randn(M),
                        0.1 * randn(D))
                z = torch.zeros(1, device=dev)

                def params(ln2s, ln2b, b1, b2):
                    return bm.BlockParams(z, z, ln2s, ln2b, z, z, b1, b2,
                                          None, None, w1, w2)

                q64, q32 = params(*vecs), params(*(v.float() for v in vecs))
                a64 = (4.0 + 0.5 * randn(b, n, D), randn(b, n, D),
                       randn(b, n, D))
                a32 = tuple(t.float() for t in a64)
                k = K.mlp_rev_core(*a32, q32, eps, mlp, rule)[1].double()
                p64 = K.mlp_rev_core_plain(*a64, q64, eps, mlp, rule)[1]
                rel = lambda t: (t.double() - p64).norm().item() / \
                    p64.norm().item()
                npl = rel(K.mlp_rev_core_plain(*a32, q32, eps, mlp, rule)[1])
                lim = F32_FACTOR * npl + F32_FLOOR
                nk = rel(k)
                mg = torch.Generator(device=dev).manual_seed(3000 + seed)
                nd = [rel(K.mlp_rev_core_plain(
                    *(ulp_moved_tensor(t, mg) for t in a32), q32, eps, mlp,
                    rule)[1]) for _ in range(DRAWS)]
                k_miss += nk > lim
                p_miss += sum(v > lim for v in nd)
                ratios.append(nk / lim)
                print(f"c5 {sname} {pname} seed {seed}: Rm |k32-p64|/|p64| "
                      f"{nk:.3e}, limit {lim:.3e} (plain f32 {npl:.3e}); "
                      f"plain f32 on ulp-moved inputs {fmt(nd)}")
            out[(sname, pname)] = (k_miss, p_miss, C5_SEEDS * DRAWS)
            print(f"c5 {sname} {(b, n, D, M)} {pname}: kernel misses the "
                  f"2-norm rule on {k_miss} of {C5_SEEDS} draws (its error "
                  f"over the limit: max {max(ratios):.3f}, median "
                  f"{float(np.median(ratios)):.3f}); the plain float32 "
                  f"version on ulp-moved inputs misses it on {p_miss} of "
                  f"{C5_SEEDS * DRAWS}")
            torch.cuda.empty_cache()
    return out


# C8: C5's rule on the MLP products that call the GEMM core's one-chain
# bf16x3 mode: B8's relevance output R_att at BERT-base widths (B7's MLP
# products are B8's recompute), and the relevance of the tensor-parallel MLP
# half, B10b from B10a's anchors as the TP program forms it (k = 1), at
# ViT-B widths; the (bf16x3 MLP, bf16 rule) pair that a tensorfloat32 base
# with a float32 attention island and a bfloat16 rule island reaches
C8_PAIR = (TF32, "bfloat16")


def c8_measurement(dev, K, bm, bmath, prec, rp, shapes):
    """C8 by c5_measurement's rule (C5_SEEDS input draws, the plain float32
    version on DRAWS ulp-moved copies of each): ``shapes`` {"B8": (B, S, h,
    hd, I), "B10": (B, n, D, M)}. The inputs are made as c5_measurement
    makes B6's: the activation the add and clone rules divide by (B8's
    att_ln, B10's x_mid) around 4 (spread 0.5), so that the measurement
    sees the products' summation and not the conditioning of a divide by
    a sum near 0 (with att_ln an LN output, as phase 3 makes it, the plain
    float32 version itself erred by 9-100 % of |p64| in R_att). Prints a line
    per draw and a summary per kernel, and fails where the kernel misses on
    a draw where no plain draw of the same input misses (the C8 repair's
    claim); returns {kernel: (kernel misses, plain-draw misses, plain
    draws, each draw's error over its limit, the seeds of the kernel's
    misses that no plain draw shares)}."""
    import torch
    mlp, rule = C8_PAIR
    eps = 1e-6
    out = {}

    def measure(name, label, run, args64, seed):
        """``run(plain, *args)`` -> the relevance, by the kernel (plain
        False) or the plain version; args64 the float64 inputs, the ones
        moved the activations'."""
        args32 = tuple(a.float() for a in args64)
        k = run(False, *args32).double()
        p64 = run(True, *args64)
        rel = lambda t: (t.double() - p64).norm().item() / p64.norm().item()
        npl = rel(run(True, *args32))
        lim = F32_FACTOR * npl + F32_FLOOR
        nk = rel(k)
        mg = torch.Generator(device=dev).manual_seed(3100 + seed)
        nd = [rel(run(True, *(ulp_moved_tensor(t, mg) for t in args32)))
              for _ in range(DRAWS)]
        print(f"c8 {name} {label} seed {seed}: |k32-p64|/|p64| {nk:.3e}, "
              f"limit {lim:.3e} (plain f32 {npl:.3e}); plain f32 on "
              f"ulp-moved inputs {fmt(nd)}")
        return nk > lim, sum(v > lim for v in nd), nk / lim, seed

    # B8: R_att of the output sub-block's reverse
    b, S, hh, dd, inter = shapes["B8"]
    D = hh * dd
    k_miss = p_miss = 0
    ratios, alone = [], []
    for seed in range(C5_SEEDS):
        gen = torch.Generator(device=dev).manual_seed(2100 + seed)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev,
                               dtype=torch.float64)

        ws = [prec.prepare_weight(randn(o, i) / i ** 0.5, mlp)
              for o, i in ((3 * D, D), (D, D), (inter, D), (D, inter))]
        vecs = [1.0 + 0.1 * randn(D), 0.1 * randn(D), 1.0 + 0.1 * randn(D),
                0.1 * randn(D), 0.1 * randn(3 * D), 0.1 * randn(D),
                0.1 * randn(inter), 0.1 * randn(D)]
        p64 = bmath.BertLayerParams(*vecs, *ws)
        p32 = bmath.BertLayerParams(*[v.float() for v in vecs], *ws)
        att_ln = 4.0 + 0.5 * randn(b, S, D)

        def run(plain, a, g, R):
            f = bmath.bert_out_rev_core_plain if plain else \
                K.bert_out_rev_core
            return f(a, g, R, p64 if a.dtype == torch.float64 else p32, eps,
                     mlp, rule, mlp)[1]

        km, pm, r, sd = measure("B8 R_att", (b, S, D, inter), run,
                            (att_ln, randn(b, S, D), randn(b, S, D)), seed)
        k_miss += km
        p_miss += pm
        ratios.append(r)
        if km and not pm:
            alone.append(sd)
        del ws, p64, p32, att_ln
    out["bert_out_rev_core"] = (k_miss, p_miss, C5_SEEDS * DRAWS, ratios,
                                alone)
    torch.cuda.empty_cache()

    # B10a -> B10b: the MLP half's relevance at the block input
    b, n, D, M = shapes["B10"]
    k_miss = p_miss = 0
    ratios, alone = [], []
    for seed in range(C5_SEEDS):
        gen = torch.Generator(device=dev).manual_seed(2200 + seed)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev,
                               dtype=torch.float64)

        w1 = prec.prepare_weight(randn(M, D) / D ** 0.5, mlp)
        w2 = prec.prepare_weight(randn(D, M) / M ** 0.5, mlp)
        vecs = (1.0 + 0.1 * randn(D), 0.1 * randn(D), 0.1 * randn(M),
                0.1 * randn(D))

        def run(plain, x_mid, g_out, R):
            ln2s, ln2b, b1, b2 = (v.to(x_mid.dtype) for v in vecs)
            ph1 = K.mlp_rev_tp_phase1_plain if plain else K.mlp_rev_tp_phase1
            ph2 = K.mlp_rev_tp_phase2_plain if plain else K.mlp_rev_tp_phase2
            fc1, fc2, axw2, _ = ph1(x_mid, g_out, ln2s, ln2b, b1, w1, w2, eps,
                                    mlp, rule)
            R1, R2 = rp.add_relprop(x_mid, fc2 + b2, R)
            Sr = rp.safe_divide(R2, 0.5 * (fc2 + axw2))
            num_w, num_a = ph2(x_mid, Sr, fc1, ln2s, ln2b, b1, w1, w2, eps,
                               rule)
            xn2 = bm.ln_fwd(x_mid, ln2s, ln2b, eps)[0]
            R2b = 0.5 * (xn2 * num_w + xn2.abs() * num_a)
            return rp.clone_relprop(x_mid, [R1, R2b])

        km, pm, r, sd = measure("B10a/B10b Rm", (b, n, D, M), run,
                            (4.0 + 0.5 * randn(b, n, D), randn(b, n, D),
                             randn(b, n, D)), seed)
        k_miss += km
        p_miss += pm
        ratios.append(r)
        if km and not pm:
            alone.append(sd)
        del w1, w2
    out["mlp_rev_tp_phase2"] = (k_miss, p_miss, C5_SEEDS * DRAWS, ratios,
                                alone)
    torch.cuda.empty_cache()
    for name, (km, pm, nd, r, alone) in out.items():
        print(f"c8 {name} {'/'.join(C8_PAIR)}: kernel misses the 2-norm rule "
              f"on {km} of {C5_SEEDS} draws (its error over the limit: max "
              f"{max(r):.3f}, median {float(np.median(r)):.3f}); the plain "
              f"float32 version on ulp-moved inputs misses it on {pm} of "
              f"{nd}; kernel misses on draws where no plain draw misses: "
              f"{alone}")
    for name, (*_, alone) in out.items():
        require(not alone, f"c8 {name}: the kernel misses the 2-norm rule "
                f"on draws {alone}, where no ulp-moved plain float32 draw "
                f"of the same input misses")
    return out


# the guarded phase (ROADMAP A6; PERF.md §2): ViT-B/16 on the 32 images of
# GUARD_DATA in GUARD_BATCHES batches of 8, BERT-base on phase 4's first
# batch; every ticket done within GUARD_TIMEOUT seconds; the strict
# deliver-f32 server's escalation budget
GUARD_DATA = "experiments/data/guarded_defer_load_in.npz"
GUARD_BATCHES = 4
GUARD_TIMEOUT = 120.0
GUARD_BUDGET = 4


def guarded_phase(dev, tag, none, params, bparams, bert_batch, corr,
                  token_corr, ulp_moved):
    """The guarded mode and its serving queue on the card, gates (a)-(g) of
    PERF.md §2: ``params`` / ``bparams`` the seeded ViT-B/16 and BERT-base
    state dicts on the card, ``bert_batch`` (ids, valid, indices) of 8
    sequences at S=512; ``corr`` / ``token_corr`` main's per-sample corr,
    ``ulp_moved(sd, seed)`` main's. The exact CPU program is held on the
    rows it re-ran by ``cpu_rows_gate``: run on the float64 card model, it
    must match the card's plain float64 path (1 - corr <= TWIN_GAP); its
    float32 rows' corr is printed beside the card's plain float32 draws
    (the weights as they are and PLAIN_DRAWS - 1 sets moved one float32
    ulp). Each path is driven with the launch counts set to 0 just before it and read just after (a server's worker
    thread launches the gpu-f32 tier's kernels beside the caller's).
    Returns the counts of every path."""
    import torch
    from transformer_explainability_torch.explain import bert_generator as bg
    from transformer_explainability_torch.explain.generator import (
        ENVELOPE_BOUNDS, STRICT_AGREEMENT, _batch_corr, _envelope_flags,
        _to_host, calibrate_envelope, explain_batch, make_cpu_exact_fn,
        make_explain_fn, make_guarded_explain_fn, precision_kwargs)
    from transformer_explainability_torch.explain.serving import (
        TIER_AGREEMENT, GuardedServer)
    from transformer_explainability_torch.models import bert as bert_mod
    from transformer_explainability_torch.models.vit import (
        VIT_BASE_16_224, VisionTransformer)
    from transformer_explainability_torch.ops import kernels as K
    t_phase = time.perf_counter()
    cfg, bcfg = VIT_BASE_16_224, bert_mod.BERT_BASE_UNCASED
    L, BL = cfg.depth, bcfg.num_layers
    prod = precision_kwargs("production")
    data = np.load(os.path.join(ROOT, GUARD_DATA))
    imgs_all = data["images"]
    idx_all = data["indices"].astype(np.int64)
    batches = [(imgs_all[8 * k:8 * k + 8], idx_all[8 * k:8 * k + 8])
               for k in range(GUARD_BATCHES)]

    def on_card(sd, make, dtype=torch.float32):
        m = make(dtype)
        m.load_state_dict({k: v.to(dtype) if v.is_floating_point() else v
                           for k, v in sd.items()})
        m.requires_grad_(False)
        return m

    vit = lambda dt: VisionTransformer(cfg, device=dev, dtype=dt)
    model, model64 = on_card(params, vit), on_card(params, vit, torch.float64)
    # the plain draws' weights: main's moved sets
    moved = [on_card(ulp_moved(params, 101 + j), vit)
             for j in range(PLAIN_DRAWS - 1)]
    cpu64 = make_cpu_exact_fn(cfg)       # the exact CPU tier on model64
    prod_fn = make_explain_fn(cfg, dev, **prod)
    f32_fn = make_explain_fn(cfg, dev)
    diag_fn = make_explain_fn(cfg, dev, with_diagnostics=True, **prod)
    launches, refs = [], {}
    mega = {"block_fwd_core": L, "block_rev_core": L}
    split = {"attn_fwd_core": L, "attn_rev_core": L}

    def same(a, b):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))

    def per(n, **counts):
        """The launch counts of ``n`` units of ``counts``."""
        out = dict(none)
        for k_, v in counts.items():
            out[k_] = v * n
        return out

    def counted(label, fn, want=None):
        """``fn()`` with the counts set to 0 before and read after; they
        must equal ``want`` (where the path's are fixed)."""
        K.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        c = K.launch_counts()
        print(f"guarded {label} launches: {c}")
        require(want is None or c == want,
                f"guarded {label}: launch counts {c}, expected {want}")
        launches.append(c)
        return res

    def ref(b):
        """Batch ``b``'s plain float64 map on the card, then its plain
        float32 maps: the weights as they are and each moved set."""
        if b not in refs:
            imgs, idx = batches[b]
            idx_t = torch.as_tensor(idx, device=dev)
            refs[b] = tuple(explain_batch(
                m, torch.as_tensor(imgs, device=dev, dtype=m.cls_token.dtype),
                idx_t, ops=K.PLAIN_OPS) for m in (model64, model, *moved))
        return refs[b]

    def cpu_rows_gate(label, rows, refs_of=None, twin=None, sim=None):
        """``rows``: [(batch, row, heatmap from the exact CPU program)].
        Gated: the exact CPU program run on the float64 card model
        (``twin(batch, row)``; make_cpu_exact_fn copies the model in its
        dtype) against the card's plain float64 path, 1 - corr <= TWIN_GAP
        on every row: the CPU tier's code (its weight copy, preprocess,
        start layer, path) computes the function. Printed only: each
        float32 row's corr against the card's plain float64 path beside the
        card's plain float32 draws (the weights as they are and the moved
        sets) and whether the rule first written for these rows,
        sample_gate against the plain float32 path as it is, holds (it did
        not on every row: PERF.md §6, PR 21)."""
        if not rows:
            print(f"guarded {label}: no row went to the CPU")
            return
        refs_of = refs_of or (lambda b, r: [t[r] for t in ref(b)])
        twin = twin or (lambda b, r: cpu64(model64, batches[b][0][r],
                                           batches[b][1][r]))
        sim = sim or (lambda x, y, b, r: corr(x[None], y[None])[0])
        c, c32, p_low, gap = [], [], [], []
        for b, r, h in rows:
            r64, r32, *moved32 = refs_of(b, r)
            c.append(sim(torch.as_tensor(h, device=dev), r64, b, r))
            c32.append(sim(r32, r64, b, r))
            p_low.append(min(sim(x, r64, b, r) for x in (r32, *moved32)))
            gap.append(1.0 - sim(torch.as_tensor(twin(b, r), device=dev),
                                 r64, b, r))
        c, c32, gap = np.asarray(c), np.asarray(c32), np.asarray(gap)
        first = c >= np.where(c32 >= MIN_CORR, MIN_CORR, c32 - PROD_MIN_SLACK)
        where = [(b, r) for b, r, _ in rows]
        print(f"guarded {label} CPU rows {where}, printed: float32 corr vs "
              f"plain f64 on the card {fmt(c)}; the card's plain f32 path "
              f"{fmt(c32)}, its draws' lowest {fmt(p_low)}; the rule first "
              f"written for these rows (sample_gate against the plain f32 "
              f"path) {'holds' if first.all() else 'FAILS'} "
              f"({first.astype(int).tolist()})")
        print(f"guarded {label} CPU rows {where}, gated: the exact CPU "
              f"program on the float64 model vs the card's plain f64 path, "
              f"1 - corr {fmt(gap)} (limit {TWIN_GAP})")
        require(bool((gap <= TWIN_GAP).all()), f"guarded {label}: the exact "
                f"CPU program in float64 on rows {where} is 1 - corr "
                f"{fmt(gap)} from the card's plain float64 path, limit "
                f"{TWIN_GAP}")

    # (a) strict, defer: the production program's heatmaps, the corr of the
    # production and float32 programs' maps as the score
    g = make_guarded_explain_fn(cfg, dev, fallback="defer", return_info=True)
    outs = counted("(a) strict defer", lambda: [g(model, *b) for b in batches],
                   per(GUARD_BATCHES, **mega, **split,
                       rollout_from_grad_cam=2))
    scores = []
    for k, ((heat, info), b) in enumerate(zip(outs, batches)):
        want = _to_host(prod_fn(model, *b))
        score = _batch_corr(want, _to_host(f32_fn(model, *b)))
        require(same(heat, want), f"guarded (a) batch {k}: heatmaps are not "
                f"bitwise the production program's")
        require(same(info["score"], score), f"guarded (a) batch {k}: score "
                f"is not bitwise the corr of the production and float32 maps")
        require(np.array_equal(info["flagged"], score < STRICT_AGREEMENT),
                f"guarded (a) batch {k}: flags are not score < "
                f"{STRICT_AGREEMENT}")
        scores.append(score)
    scores = np.concatenate(scores)
    low = scores < STRICT_AGREEMENT
    print(f"guarded (a) strict defer on {len(scores)} images: flag rate "
          f"{low.mean():.4f} ({int(low.sum())} below {STRICT_AGREEMENT}), "
          f"score min {scores.min():.6f} median {np.median(scores):.6f}; "
          f"per image {fmt(scores)}")

    # (b) strict, sync, every row flagged, n_valid=2: two CPU re-runs, the
    # pad rows the production program's
    g = make_guarded_explain_fn(cfg, dev, agreement=2.0, return_info=True)
    t0 = time.perf_counter()
    heat, info = counted("(b) strict sync",
                         lambda: g(model, *batches[0], n_valid=2),
                         per(1, **mega, **split, rollout_from_grad_cam=2))
    dt = time.perf_counter() - t0
    calls = g.cpu_exact.copy.calls
    print(f"guarded (b) strict sync agreement 2.0 n_valid 2: flagged "
          f"{info['flagged'].astype(int).tolist()}, {calls} CPU calls, "
          f"{dt:.2f} s for the batch {tag}")
    require(calls == 2 and info["flagged"].tolist() == [True] * 2 + [False]
            * 6, f"guarded (b): {calls} CPU calls, flags {info['flagged']}")
    require(same(heat[2:], _to_host(prod_fn(model, *batches[0]))[2:]),
            "guarded (b): pad rows are not the production program's")
    cpu_rows_gate("(b)", [(0, r, heat[r]) for r in range(2)])

    # (c) envelope: JAX's bounds on the 32 images; bounds calibrated on the
    # port's own diagnostics of images 0-15, counted on images 16-31
    g = make_guarded_explain_fn(cfg, dev, mode="envelope", fallback="defer",
                                return_info=True)
    outs = counted("(c) envelope", lambda: [g(model, *b) for b in batches],
                   per(GUARD_BATCHES, **mega, rollout_from_grad_cam=1))
    diags = []
    for k, ((heat, info), b) in enumerate(zip(outs, batches)):
        h_d, d_d = diag_fn(model, *b)
        d = _to_host(d_d).astype(np.float64)
        require(same(heat, _to_host(h_d)) and same(info["score"], d[:, 6])
                and np.array_equal(info["flagged"],
                                   _envelope_flags(d, ENVELOPE_BOUNDS)),
                f"guarded (c) batch {k}: heatmaps, score or flags are not the "
                f"diagnostics program's")
        diags.append(d)
    diags = np.concatenate(diags)
    jax_flags = _envelope_flags(diags, ENVELOPE_BOUNDS)
    half = len(diags) // 2
    bounds = calibrate_envelope(diags[:half], 1.3)
    cal_flags = _envelope_flags(diags[half:], bounds)
    out_of = {f: int(((diags[:, j] < lo) | (diags[:, j] > hi)).sum())
              for j, (f, (lo, hi)) in enumerate(ENVELOPE_BOUNDS.items())}
    print(f"guarded (c) envelope, not gated: JAX's ENVELOPE_BOUNDS (TPU, "
          f"JAX's seed-0 weights) flag {int(jax_flags.sum())} of "
          f"{len(diags)} images (per field out of bounds: {out_of}); bounds "
          f"calibrated on images 0-{half - 1} (margin 1.3) flag "
          f"{int(cal_flags.sum())} of images {half}-{len(diags) - 1}")

    # (d) the gpu-f32 tier: every row flagged, serve_stream(depth=4) over
    # two batches; the tier's calls recorded by a wrapper of this script
    flag_all = {f: (np.inf, -np.inf) for f in ENVELOPE_BOUNDS}
    srv = GuardedServer(cfg, dev, mode="envelope", envelope_bounds=flag_all,
                        tier="gpu-f32")
    tier_program, recorded = srv._tier_fn, []

    def recording(m, im, ix):
        out = tier_program(m, im, ix)
        recorded.append((np.array(im), np.array(ix), _to_host(out)))
        return out

    srv._tier_fn = recording

    def serve_d():
        tickets = list(srv.serve_stream(model, iter(batches[:2]), depth=4))
        ok = [t.wait(GUARD_TIMEOUT) for t in tickets]
        return tickets, ok

    t0 = time.perf_counter()
    tickets, ok = counted("(d) tier", serve_d)
    dt = time.perf_counter() - t0
    srv.drain(GUARD_TIMEOUT)           # raises rather than hang the script
    s = srv.stats()
    srv.close()
    n_mb = len(recorded)
    want = per(2, **mega)
    want.update({k_: n_mb * v for k_, v in split.items()},
                rollout_from_grad_cam=2 + n_mb)
    require(launches[-1] == want, f"guarded (d): launches {launches[-1]} "
            f"for {n_mb} micro-batches, expected {want}")
    print(f"guarded (d) envelope gpu-f32 tier, every row flagged, "
          f"serve_stream depth 4 over 2 batches: tickets done {ok}, "
          f"{dt:.2f} s; {n_mb} micro-batches; stats {json.dumps(s)} {tag}")
    require(all(ok), f"guarded (d): tickets not done in {GUARD_TIMEOUT} s")
    require(s["n_errors"] == 0 and s["n_flagged"] == 16
            and s["n_tier_cleared"] + s["n_escalated"]
            == s["n_flagged"] - s["n_shed"],
            f"guarded (d): stats {s}")
    esc, cleared = [], 0
    for k, ((imgs, idx), t) in enumerate(zip(batches[:2], tickets)):
        fast = _to_host(diag_fn(model, imgs, idx)[0])
        for r in range(8):
            hit = [(im_, out) for im_, ix_, out in recorded
                   for p in range(len(ix_))
                   if ix_[p] == idx[r] and same(im_[p], imgs[r])]
            require(hit, f"guarded (d): row {(k, r)} in no micro-batch")
            im_, out = hit[0]
            p = next(p for p in range(len(im_)) if same(im_[p], imgs[r]))
            c = _batch_corr(fast[r][None], out[p][None])[0]
            if c >= TIER_AGREEMENT:
                cleared += 1
                require(same(t.heatmaps[r], out[p]), f"guarded (d): cleared "
                        f"row {(k, r)} is not the FP32 micro-batch's output")
            else:
                esc.append((k, r, t.heatmaps[r]))
    require(cleared == s["n_tier_cleared"] and len(esc) == s["n_escalated"],
            f"guarded (d): {cleared} cleared and {len(esc)} escalated rows "
            f"against the stats' {s['n_tier_cleared']} and "
            f"{s['n_escalated']}")
    im_, ix_, out = recorded[0]
    again = _to_host(tier_program(model, im_, ix_))
    print(f"guarded (d) {cleared} rows cleared bitwise their micro-batch's "
          f"FP32 output, {len(esc)} escalated; the first micro-batch run "
          f"again: {'bitwise equal' if same(again, out) else 'DIFFERS'}")
    require(same(again, out), "guarded (d): a micro-batch run again differs")
    cpu_rows_gate("(d) escalated", esc)

    # (e) strict deliver-f32 with an escalation budget, serve_stream over
    # the four batches; beside it the bare production program's rate
    srv = GuardedServer(cfg, dev, mode="strict", strict_policy="deliver-f32",
                        escalation_budget=GUARD_BUDGET)
    waiting = []

    def serve_e():
        tickets = []
        for t in srv.serve_stream(model, iter(batches), depth=4):
            waiting.append(srv._q.qsize())
            tickets.append(t)
        return tickets, time.perf_counter()

    t0 = time.perf_counter()
    tickets, t1 = counted("(e) strict deliver-f32", serve_e,
                          per(GUARD_BATCHES, **mega, **split,
                              rollout_from_grad_cam=2))
    ok = [t.wait(GUARD_TIMEOUT) for t in tickets]
    srv.drain(GUARD_TIMEOUT)
    s = srv.stats()
    srv.close()
    stream_rate = 8 * GUARD_BATCHES / (t1 - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        prod_fn(model, *b)
    torch.cuda.synchronize()
    bare_rate = 8 * GUARD_BATCHES / (time.perf_counter() - t0)
    delivered = sum(int((t.delivered_f32 & ~t.flagged).sum())
                    for t in tickets)
    below = sum(int(t.delivered_f32.sum()) for t in tickets)
    shed = sum(int(t.shed.sum()) for t in tickets if t.shed is not None)
    print(f"guarded (e) strict deliver-f32, budget {GUARD_BUDGET}, "
          f"serve_stream depth 4 over {GUARD_BATCHES} batches: "
          f"{stream_rate:.1f} expl/s (the bare production program "
          f"{bare_rate:.1f} expl/s in the same window); flag rate "
          f"{below / (8 * GUARD_BATCHES):.4f}, f32-delivered "
          f"{s['n_f32_delivered']}, escalated {s['n_flagged']}, shed "
          f"{s['n_shed']}; queue wait p50 {s.get('queue_wait_p50_s', 0):.3f}"
          f" s p95 {s.get('queue_wait_p95_s', 0):.3f} s, verifier busy "
          f"{s['verifier_busy_frac']:.3f}; rows waiting after each batch "
          f"{waiting}; tickets done {ok} {tag}")
    require(all(ok), f"guarded (e): tickets not done in {GUARD_TIMEOUT} s")
    require(max(waiting) <= GUARD_BUDGET, f"guarded (e): {max(waiting)} rows "
            f"waited for the CPU, budget {GUARD_BUDGET}")
    require(s["n_errors"] == 0 and shed == s["n_shed"]
            and delivered == s["n_f32_delivered"], f"guarded (e): stats {s}")
    corrected = []
    for k, (b, t) in enumerate(zip(batches, tickets)):
        co = _to_host(f32_fn(model, *b))
        rows = np.flatnonzero(t.delivered_f32 & ~t.flagged)
        require(same(t.heatmaps[rows], co[rows]), f"guarded (e) batch {k}: "
                f"f32-delivered rows are not the co-run's")
        corrected += [(k, r, t.heatmaps[r]) for r in sorted(t.corrections)]
    cpu_rows_gate("(e) corrected", corrected)

    # (f) the uint8 wire format, strict, every row flagged, n_valid=2
    imgs, idx = batches[0]
    u8 = np.clip(np.rint((imgs * 0.5 + 0.5) * 255.0), 0, 255).astype(
        np.uint8).transpose(0, 2, 3, 1)
    srv = GuardedServer(cfg, dev, mode="strict", agreement=2.0,
                        input_format="uint8")

    def serve_f():
        t = srv.submit(model, u8, idx, n_valid=2)
        return t, t.wait(GUARD_TIMEOUT)

    t, done = counted("(f) uint8", serve_f,
                      per(1, **mega, **split, rollout_from_grad_cam=2))
    srv.drain(GUARD_TIMEOUT)
    srv.close()
    exact = make_cpu_exact_fn(cfg, preprocess="uint8")
    eq = [same(t.heatmaps[r], exact(model, u8[r], idx[r])) for r in range(2)]
    print(f"guarded (f) uint8 strict agreement 2.0 n_valid 2: corrected rows "
          f"{sorted(t.corrections)}, equal to make_cpu_exact_fn(preprocess="
          f"'uint8') on the same frames: {eq}")
    require(done and sorted(t.corrections) == [0, 1] and all(eq),
            "guarded (f): uint8 rows are not the uint8 CPU verifier's")

    # (g) BERT-base, strict: defer bitwise production; sync with every row
    # flagged and n_valid=1, its CPU row against the card's plain f64 path
    bert = lambda dt: bert_mod.BertForSequenceClassification(bcfg, device=dev,
                                                             dtype=dt)
    bmodel = on_card(bparams, bert)
    ids, valid, bidx = bert_batch
    gb = bg.make_guarded_bert_explain_fn(bcfg, dev, fallback="defer",
                                         return_info=True)
    bb = {"bert_layer_fwd_core": BL, "bert_out_rev_core": BL,
          "bert_attn_rev_core": BL}
    heat, info = counted("(g) bert defer",
                         lambda: gb(bmodel, ids, valid, bidx),
                         per(1, **bb, rollout_from_grad_cam=2))
    bprod = _to_host(bg.make_explain_fn(bcfg, dev, **prod)(bmodel, ids, valid,
                                                          bidx))
    require(same(heat, bprod), "guarded (g): BERT defer rows are not the "
            "production program's")
    gs = bg.make_guarded_bert_explain_fn(bcfg, dev, agreement=2.0,
                                         return_info=True)
    heat, info2 = counted("(g) bert sync",
                          lambda: gs(bmodel, ids, valid, bidx, n_valid=1),
                          per(1, **bb, rollout_from_grad_cam=2))
    require(gs.cpu_exact.copy.calls == 1 and same(heat[1:], bprod[1:])
            and info2["flagged"].tolist() == [True] + [False] * 7,
            "guarded (g): BERT sync re-ran another row than row 0")
    bmodel64 = on_card(bparams, bert, torch.float64)
    bmoved = [on_card(ulp_moved(bparams, 201 + j), bert)
              for j in range(PLAIN_DRAWS - 1)]
    bcpu64 = bg.make_cpu_exact_bert_fn(bcfg)
    ids_t, v_t, i_t = (torch.as_tensor(a, device=dev)
                       for a in (ids[:1], valid[:1], bidx[:1]))
    brefs = [bg.explain_batch(m, ids_t, v_t, i_t, ops=K.BERT_PLAIN_OPS)[0]
             for m in (bmodel64, bmodel, *bmoved)]
    print(f"guarded (g) bert strict defer: scores {fmt(info['score'])}")
    cpu_rows_gate(
        "(g) bert", [(0, 0, heat[0])], refs_of=lambda b, r: brefs,
        twin=lambda b, r: bcpu64(bmodel64, ids[r], valid[r], bidx[r]),
        sim=lambda x, y, b, r: token_corr(x[None], y[None], v_t.bool())[0])
    del bmodel, bmodel64, bmoved, bcpu64

    # the host's contention: the production program's rate with the CPU
    # verifier idle and with it busy in a thread beside it (printed)
    def rate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            for b in batches:
                prod_fn(model, *b)
        torch.cuda.synchronize()
        return 16 * GUARD_BATCHES / (time.perf_counter() - t0)

    idle = rate()
    busy_calls, stop = [], threading.Event()
    cpu_exact = make_cpu_exact_fn(cfg)

    def busy():
        while not stop.is_set():
            cpu_exact(model, imgs[0], idx[0])
            busy_calls.append(1)

    worker = threading.Thread(target=busy)
    cpu_exact.copy(model)                     # the copy, before the window
    worker.start()
    time.sleep(0.2)
    busy_rate = rate()
    stop.set()
    worker.join()
    print(f"guarded production rate with the CPU verifier idle "
          f"{idle:.1f} expl/s, busy beside it {busy_rate:.1f} expl/s "
          f"({len(busy_calls)} CPU verifications, torch CPU threads "
          f"{torch.get_num_threads()}) {tag}")
    print(f"guarded phase: {time.perf_counter() - t_phase:.1f} s")
    del model, model64, refs, moved, cpu64
    torch.cuda.empty_cache()
    return launches


# the new end-to-end paths of A3b (phase 4): ViT-B/16 on the three
# batches, each by preset_gate against the same path's plain float64
# version on the card, PLAIN_DRAWS plain float32 draws on the card, the
# kernel path on the moved weights its witnesses; launches a batch:
# "mega" B2 + B3 a block and B1, "split" B4 + B5 a block and B1
TF32_PATHS = {
    "tensorfloat32": (dict(matmul_precision=TF32), "mega"),
    "tf32 split arm": (dict(matmul_precision=TF32, block_kernel=False),
                       "split"),
    "float32 + tf32 attention island": (dict(attn_precision=TF32), "split"),
    "float32 + tf32 rule island": (dict(relprop_precision=TF32), "split"),
}


def tf32_paths_phase(dev, tag, params, cfg, batches, exact64, drive,
                     preset_corrs, corr, moved_vit, none):
    """Drive each of TF32_PATHS through ``Explainer`` (launch counts,
    bitwise repeatable; ``drive``), gate it by preset_gate (``preset_corrs(
    model32, heats, kw, moved)``: main's, against the plain float64 model,
    with witnesses) and print its fidelity (corr) against the exact float64
    path, ``exact64`` (the three batches' float64 heatmaps of the float32
    preset's plain path). Returns {label: launch counts}."""
    import torch
    from transformer_explainability_torch import Explainer
    L = cfg.depth
    counts = {}
    for label, (kw, route) in TF32_PATHS.items():
        t0 = time.perf_counter()
        per = {**none, "rollout_from_grad_cam": 1}
        per.update({"block_fwd_core": L, "block_rev_core": L} if route ==
                   "mega" else {"attn_fwd_core": L, "attn_rev_core": L})
        ex = Explainer(params, cfg, device="cuda", **kw)
        heats, counts[label] = drive(ex.explain, batches,
                                     (8, cfg.num_patches), per, label)
        c, c_plain, c_moved, k_moved = preset_corrs(ex.model, heats, kw,
                                                    moved_vit)
        preset_gate(f"{label} slice", c, [c_plain, *c_moved], k_moved)
        fid = np.asarray(sum((corr(hk, ref) for hk, ref in zip(heats,
                                                                exact64)),
                             []))
        print(f"{label} slice corr vs exact f64 (float32 preset, plain) on "
              f"the card, not gated: min {fid.min():.6f} median "
              f"{np.median(fid):.6f} mean {fid.mean():.6f}; per sample "
              f"{fmt(fid)} ({time.perf_counter() - t0:.1f} s) {tag}")
        del ex, heats
        torch.cuda.empty_cache()
    return counts


def tf32_times(tag, K, bm, inputs):
    """Phase 5's times of the bf16×3 instances at ViT-B/16's main shapes
    (``inputs``: tf32_kernel_checks'): ms per call (CUDA events) beside the
    plain version and the bound (bytes over 3.35 TB/s or the products as
    three bf16 passes at 989 TFLOP/s, float32 ones at 67, whichever is
    larger); B4's beside one scaled_dot_product_attention call on the same
    q, k, v in float32 (timed only; the port never calls it); B5 in every
    pair of TF32_B5_PAIRS. Returns {name: (ms, plain ms, bound ms, bound
    by, library ms or None)} of the kernels line's bf16×3 entries (B5 at
    bf16×3 / bf16×3, B2 and B3 raw tensorfloat32)."""
    import torch

    def bound(nbytes, bf16=0, bf16x3=0, f32=0):
        t_mem = nbytes / HBM_BYTES_S
        t_ops = (bf16 + 3 * bf16x3) / BF16_FLOPS + f32 / FP32_FLOPS
        return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                          else "operations")

    qkv, h, hd, scale = inputs["attn_fwd_core"]
    b, n = qkv.shape[:2]
    D, R, f4 = h * hd, b * n, 4
    at = b * h * n * n * hd             # half the FLOPs of one (n, n, hd)
    out = {}
    t = (time_ms(lambda: K.attn_fwd_core(qkv, h, hd, scale, mxu=TF32), 200),
         time_ms(lambda: K.attn_fwd_core_plain(qkv, h, hd, scale, TF32)))
    q_, k_, v_ = bm.split_heads(qkv, h, hd)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_, k_, v_, scale=scale), 200)
    out["attn_fwd_core"] = (*t, *bound(f4 * 4 * R * D, bf16x3=4 * at), lib)
    args = inputs["attn_rev_core"]
    for a, r in TF32_B5_PAIRS:
        kw = dict(attn_mxu=a, rule_mxu=r)
        t = (time_ms(lambda: K.attn_rev_core(*args, **kw)),
             time_ms(lambda: K.attn_rev_core_plain(*args, **kw)))
        ops = {"f32": 0, "bf16": 0, "bf16x3": 0}
        mode = {"float32": "f32", "bfloat16": "bf16", TF32: "bf16x3"}
        ops[mode[a]] += 12 * at     # recompute and gradient products
        ops[mode[r]] += 8 * at      # rule products
        bd = bound(f4 * (11 * R * D + b * n * n), **ops)
        print(f"time attn_rev_core {(b, n, h, hd)} f32 {a}/{r} modes: "
              f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {bd[0]:.4f}"
              f" ms ({bd[1]}), {t[0] / bd[0]:.1f}x the bound {tag}")
        if a == r == TF32:
            out["attn_rev_core"] = (*t, *bd, None)
    x, p32, *fargs = inputs["block_fwd_core"]
    a32, _, rargs, s32 = inputs["block_rev_core"]
    M = p32.b1.shape[0]
    pr = 4 * 4 * D * D + 2 * 2 * 2 * M * D   # the four weights' (hi, lo)
    t = (time_ms(lambda: K.block_fwd_core(x, p32, *fargs)),
         time_ms(lambda: bm.block_fwd_core_plain(x, p32, *fargs)))
    out["block_fwd_core"] = (*t, *bound(
        f4 * (9 * D + M) + pr + f4 * (R * D + 8 * R * D + 2 * b * h * n * n
                                      + R * M),
        bf16x3=8 * R * D * D + 4 * at + 4 * R * D * M), None)
    t = (time_ms(lambda: K.block_rev_core(*a32, p32, *rargs, saved=s32)),
         time_ms(lambda: bm.block_rev_core_plain(*a32, p32, *rargs,
                                                 saved=s32)))
    out["block_rev_core"] = (*t, *bound(
        2 * pr + f4 * (9 * D + M) + f4 * (10 * R * D + 2 * b * h * n * n
                                          + R * M)
        + f4 * (2 * R * D + b * n * n),
        bf16x3=16 * R * D * M + 32 * R * D * D + 16 * at), None)
    for name, (ms, pms, bd, by, lib_ms) in out.items():
        print(f"time {name} tensorfloat32 {(b, n, h, hd)} f32: kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bd:.4f} ms ({by}), "
              f"{ms / bd:.1f}x the bound"
              + (f"; scaled_dot_product_attention f32 {lib_ms:.4f} ms"
                 if lib_ms is not None else "") + f" {tag}")
    return out


def main() -> int:
    t_start = time.perf_counter()
    marks = [t_start]

    def phase_mark(name):
        """Print the seconds since the last mark (a phase's) and since the
        start."""
        now = time.perf_counter()
        print(f"phase {name}: {now - marks[-1]:.1f} s (elapsed "
              f"{now - t_start:.0f} s)")
        marks.append(now)

    # transformers, where phase 1 finds it, reads local files only
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
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
        remarks, redesign_spills, nvcc_secs, source = [], [], [], None
        for line in log.read_text().splitlines():
            if line.startswith("/") and " -c -o " in line:
                source = line.split()[-1].rsplit("/", 1)[-1]
            elif line.startswith("seconds") and source:
                nvcc_secs.append((float(line.split()[1]), source))
                source = None
            elif "Compiling entry function" in line:
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
                    r"attn_fwd_kernelI[fd]Li[012]ELi\d+ELb1E", entry)) or (
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
        print("  nvcc seconds a source (all at once): " + ", ".join(
            f"{src} {sec:.1f}" for sec, src in sorted(nvcc_secs,
                                                      reverse=True)))
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

    phase_mark("1-2, the device and the build")
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
            n, h, hd, hd ** -0.5, K._ATTN_MODE[attn], K._ATTN_MODE[rule],
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
    # products with bf16 rules, is checked at ViT-B only; at ViT-L one draw
    # of its Rm is a draw of an ill-conditioned function, and
    # c5_measurement holds it over 16 draws beside the plain version's,
    # ROADMAP C5)
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
    # the bf16x3 instances of B2-B5 (A3b) at ViT-B/16's main and ragged
    # shapes, ViT-L/16's and n = 198, then C5 on B6 (the MLP half B3
    # shares) at ViT-B and ViT-L widths
    t0 = time.perf_counter()
    tf32_errs, tf32_inputs = tf32_kernel_checks(dev, K, bm, prec, {
        "main": shapes["main"], "ragged": shapes["ragged"],
        "ViT-L": new_shapes["ViT-L"][:4], "n=198": new_shapes["n=198"][:4]})
    print(f"bf16x3 kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    c5_measurement(dev, K, bm, prec, {
        "ViT-B": tp_shapes["main"],
        "ViT-L": (B, n, VIT_LARGE_16_224.embed_dim,
                  VIT_LARGE_16_224.mlp_dim)})
    print(f"C5 measurement: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    c8_measurement(dev, K, bm, bmath, prec, rp, {
        "B8": bert_shapes["main"], "B10": tp_shapes["main"]})
    print(f"C8 measurement: {time.perf_counter() - t0:.1f} s")

    phase_mark("3, kernels against their plain versions")
    # 4. the slice ----------------------------------------------------------
    data = np.load(os.path.join(ROOT, "experiments/data/fidelity_truth.npz"))
    imgs_all, idx_all = data["imgs"], data["idx"].astype(np.int64)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=dev)
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

    def ulp_moved(sd, seed):
        """A float32 state dict with every element moved to a float32
        neighbour, up or down at random (seeded): the same function in
        another float32 draw."""
        g = torch.Generator(device=dev).manual_seed(seed)
        inf = torch.tensor(float("inf"), device=dev)
        return {k: torch.where(torch.rand(v.shape, generator=g, device=dev)
                               < 0.5, torch.nextafter(v, inf),
                               torch.nextafter(v, -inf))
                if v.is_floating_point() else v for k, v in sd.items()}

    def moved_draws(make, sd, seed):
        """PLAIN_DRAWS - 1 float32 models (``make()``) on ``sd`` moved one
        float32 ulp, seeds ``seed``, ``seed + 1``, ...: with the weights as
        they are, the draws of the presets' gates."""
        out = []
        for j in range(PLAIN_DRAWS - 1):
            m = make()
            m.load_state_dict(ulp_moved(sd, seed + j))
            m.requires_grad_(False)
            out.append(m)
        return out

    def preset_corrs(model32, model64_, heats_, kw, moved32=(), mcfg=cfg,
                     witness=False):
        """Per-sample corr against the plain float64 path of the same
        arguments (preset, method) on the three batches: of the kernel
        path's heatmaps ``heats_``, of the plain float32 path's, of the
        plain float32 path's on each model of ``moved32`` (the weights
        moved one float32 ulp) and, with ``witness``, of the kernel path's
        on those moved weights (the gates' witnesses; their launches are
        not the main path's)."""
        moved_ex = [Explainer(m.state_dict(), mcfg, device="cuda",
                              **{k: v for k, v in kw.items()
                                 if k != "method"})
                    for m in moved32] if witness else []
        method = {k: v for k, v in kw.items() if k == "method"}
        c, c_plain = [], []
        c_moved = [[] for _ in moved32]
        c_kmoved = [[] for _ in moved_ex]
        for (imgs, idx), heat in zip(batches, heats_):
            idx_t = torch.as_tensor(idx, device=dev)
            ref = explain_batch(model64_, torch.as_tensor(
                imgs, device=dev, dtype=torch.float64), idx_t,
                ops=K.PLAIN_OPS, **kw)
            c += corr(heat, ref)
            img32 = torch.as_tensor(imgs, device=dev)
            c_plain += corr(explain_batch(model32, img32, idx_t,
                                          ops=K.PLAIN_OPS, **kw), ref)
            for acc, m in zip(c_moved, moved32):
                acc += corr(explain_batch(m, img32, idx_t, ops=K.PLAIN_OPS,
                                          **kw), ref)
            for acc, exm in zip(c_kmoved, moved_ex):
                acc += corr(exm.explain(imgs, idx, **method), ref)
        del moved_ex
        return (np.asarray(c), np.asarray(c_plain),
                [np.asarray(a) for a in c_moved],
                [np.asarray(a) for a in c_kmoved])

    def gate(label, c, c_plain, kind, c_moved=(), k_moved=None):
        """``median``: :func:`preset_gate` against the plain float32 draws
        ``[c_plain, *c_moved]`` with the kernel path's draws ``k_moved`` as
        its witnesses; ``per-sample`` (exact FP32, as the ViT methods are
        held): :func:`sample_gate` against the lowest of those plain draws
        per sample."""
        if kind == "median":
            preset_gate(label, c, [c_plain, *c_moved], k_moved or ())
        else:
            sample_gate(label, c, np.min([c_plain, *c_moved], axis=0),
                        k_moved)

    moved_vit = moved_draws(lambda: VisionTransformer(cfg, device=dev),
                            params, 101)
    # the exact FP32 slice by the per-sample rule, the kernel path's draws
    # on the moved weights its witnesses (the seed-0 model drawn on the CPU
    # has a sample that is ill-conditioned in exact FP32, PERF.md PR 17);
    # production by the presets' gate
    corrs, plain_corrs, _, k32_moved = preset_corrs(
        ex.model, model64, heats, {}, moved_vit, witness=True)
    sample_gate("slice", corrs, plain_corrs, k32_moved)
    p_corrs, p_plain_corrs, p_moved, pk_moved = preset_corrs(
        ex_prod.model, model64, heats_prod, prod, moved_vit, witness=True)
    p_exact = []
    for (imgs, idx), heat_p in zip(batches, heats_prod):
        p_exact += corr(heat_p, explain_batch(
            model64, torch.as_tensor(imgs, device=dev, dtype=torch.float64),
            torch.as_tensor(idx, device=dev), ops=K.PLAIN_OPS))
    p_exact = np.asarray(p_exact)
    print(f"production slice corr vs exact f64 (float32 preset, plain) on "
          f"the card, not gated: min {p_exact.min():.6f} median "
          f"{np.median(p_exact):.6f} mean {p_exact.mean():.6f}; per sample "
          f"{fmt(p_exact)}")
    preset_gate("production slice", p_corrs, [p_plain_corrs, *p_moved],
                pk_moved)

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
    s_mega = np.asarray(sum((corr(a, b_.double()) for a, b_ in zip(
        heats_split, heats_bf16)), []))
    print(f"split bfloat16 slice corr vs the megakernel bfloat16 path, not "
          f"gated: min {s_mega.min():.6f} median {np.median(s_mega):.6f}; "
          f"per sample {fmt(s_mega)}")
    s_corrs, s_plain_corrs, s_moved, sk_moved = preset_corrs(
        ex_split.model, model64, heats_split, split, moved_vit,
        witness=True)
    preset_gate("split bfloat16 slice", s_corrs, [s_plain_corrs, *s_moved],
                sk_moved)
    del ex_split, ex_bf16

    # raw tensorfloat32 on the megakernels, the tf32 split arm and the
    # float32 base's tensorfloat32 islands (A3b), each gated as the split
    # path is; their fidelity against the exact float64 path printed
    exact64 = [explain_batch(model64, torch.as_tensor(
        imgs, device=dev, dtype=torch.float64), torch.as_tensor(
        idx, device=dev), ops=K.PLAIN_OPS) for imgs, idx in batches]
    tf32_launches = tf32_paths_phase(
        dev, tag, params, cfg, batches, exact64, drive,
        lambda m32, hs, kw, mv: preset_corrs(m32, model64, hs, kw, mv,
                                             witness=True),
        corr, moved_vit, none)
    del exact64

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
    c_mlp, cp_mlp, cm_mlp, ck_mlp = preset_corrs(
        ex_mlp.model, model64, heats_mlp, mlp_split_kw, moved_vit,
        witness=True)
    gate("production mlp split (fwd bfloat16, bwd tensorfloat32)", c_mlp,
         cp_mlp, "median", cm_mlp, ck_mlp)
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
        sample_gate(f"{label} (0/0 in {int((~ok).sum())})",
                    corr(heat[ok], ref[ok]), corr(plain32[ok], ref[ok]))
    del model64, ex_lrp, explainers, img64
    torch.cuda.empty_cache()

    # ViT-L/16 (24 blocks, D=1024, h=16, M=4096) and DeiT-base distilled
    # (n = 198), random weights from the seeded init_params, on the same
    # three batches: exact FP32 (B4, B5, B1) and production (B2, B3, B1)
    # for both, and rollout_attn (the non-kernel branch and B1) for DeiT;
    # each gated against the port's plain path of the same arguments in
    # float64 on the card, as ViT-B's presets and methods are; the plain
    # float32 draws are the weights as they are and moved one float32 ulp
    # (two in exact FP32; PLAIN_DRAWS in production, whose kernel path
    # runs on the moved weights too, the gate's witnesses). At 24 blocks
    # exact FP32 is ill-conditioned for any float32 implementation on these
    # random weights: on an H100 the plain float32 path reached corr
    # -0.035, 0.754 and 0.393 on three of ViT-L's 24 samples, and over
    # eight draws of the weights moved one float32 ulp both paths
    # scattered, each on samples
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
        mparams = init_params(mcfg, generator=torch.Generator()
                              .manual_seed(0), device=dev)
        m64 = VisionTransformer(mcfg, device=dev, dtype=torch.float64)
        m64.load_state_dict({k: v.double() for k, v in mparams.items()})
        m64.requires_grad_(False)
        moved_m = moved_draws(lambda: VisionTransformer(mcfg, device=dev),
                              mparams, 98)
        m32u = moved_m[0]
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
            c, c_plain, c_moved, k_moved = preset_corrs(
                exm.model, m64, hs, kw,
                moved_m if kw is prod else moved_m[:1], mcfg,
                witness=kw is prod)
            gate(f"{mname} {label}", c, c_plain, kind, c_moved,
                 k_moved if kw is prod else None)
            new_explainers[(mname, label)] = exm
            new_heats[(mname, label)] = hs
        if mcfg.distilled:
            deit_ref = (mparams, m64, m32u)
        del mparams, m64, m32u, moved_m
        torch.cuda.empty_cache()

    # BERT-base, both presets: three batches of 8 at S=512, each sample
    # padded to its own length, two argmax indices per batch
    bparams = bert_mod.init_params(bcfg, generator=torch.Generator()
                                   .manual_seed(0), device=dev)
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
    moved_bert = moved_draws(
        lambda: bert_mod.BertForSequenceClassification(bcfg, device=dev),
        bparams, 201)
    # the kernel path on the moved weights: the production gate's witnesses
    # (their launches are not the main path's)
    bex_moved = [BertExplainer(m.state_dict(), bcfg, device="cuda", **prod)
                 for m in moved_bert]
    bc, bc_plain, bpc, bpc_plain, bp_exact = [], [], [], [], []
    bp_moved = [[] for _ in moved_bert]
    bk_moved = [[] for _ in moved_bert]
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
        for acc, m in zip(bp_moved, moved_bert):
            acc += token_corr(bg.explain_batch(
                m, ids_t, m_t, idx_t, ops=K.BERT_PLAIN_OPS, **prod), ref_p,
                v_t)
        for acc, exm in zip(bk_moved, bex_moved):
            acc += token_corr(exm.explain(ids, valid, idx), ref_p, v_t)
        bp_exact += token_corr(heat_p, ref, v_t)
    del moved_bert, bex_moved
    bc, bc_plain = np.asarray(bc), np.asarray(bc_plain)
    bpc, bpc_plain, bp_exact = (np.asarray(a) for a in (bpc, bpc_plain,
                                                        bp_exact))
    print(f"bert float32 slice corr vs plain f64 on the card: min "
          f"{bc.min():.6f} median {np.median(bc):.6f} over {len(bc)} samples "
          f"(plain f32 path: min {bc_plain.min():.6f} median "
          f"{np.median(bc_plain):.6f}); per sample {fmt(bc)}")
    require(bc.min() >= MIN_CORR, f"bert float32 per-sample corr "
            f"{bc.min():.6f} below {MIN_CORR}")
    print(f"bert production slice corr vs exact f64 (float32 preset, plain) "
          f"on the card, not gated: min {bp_exact.min():.6f} median "
          f"{np.median(bp_exact):.6f} mean {bp_exact.mean():.6f}; per sample "
          f"{fmt(bp_exact)}")
    # BERT production's answer is ill-conditioned on a few random-weight
    # samples for any float32 implementation: one bf16 rounding that falls
    # the other way (float32 vs float64 operands) moves a near-zero add-rule
    # denominator, and the sample's map with it (PERF.md §6, PR 3)
    preset_gate("bert production slice", bpc,
                [bpc_plain, *map(np.asarray, bp_moved)],
                [np.asarray(a) for a in bk_moved])

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
        sample_gate(f"{label} (0/0 in {int((~ok).sum())})",
                    token_corr(heat[ok], ref[ok], v_ok),
                    token_corr(plain32[ok], ref[ok], v_ok))
    del bmodel64, bex_lrp, bexplainers, ref, plain32
    torch.cuda.empty_cache()
    phase_mark("4, the slices, methods and configurations")

    # the guarded mode and its serving queue (A6), gates (a)-(g)
    guarded_launches = guarded_phase(dev, tag, none, params, bparams,
                                     bert_batches[0], corr, token_corr,
                                     ulp_moved)
    phase_mark("4, the guarded mode")
    reduced_launches = reduced_base_phase(dev, tag, none, params, batches,
                                          bparams, bert_batches, drive, corr,
                                          token_corr, ulp_moved)
    torch.cuda.empty_cache()
    phase_mark("4, the reduced bases")
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
        # float32: the kernel program on the moved weights of the
        # single-device slice, the witnesses of its per-sample rule
        moved_sh = [shard_tp_params(m.state_dict(), cfg, mode=mode)
                    for m in moved_vit] if label == "float32" else []
        c_k, c_p, c_single = [], [], []
        k_moved = [[] for _ in moved_sh]
        for (imgs, idx), heat, heat_1 in zip(batches, heats_tp,
                                             single[label]):
            ref = plain_fn(sh64, imgs, idx)
            c_k += corr(heat, ref)
            c_p += corr(plain_fn(sh32, imgs, idx), ref)
            c_single += corr(heat, heat_1.double())
            for acc, sh in zip(k_moved, moved_sh):
                acc += corr(fn(sh, imgs, idx), ref)
        c_single = np.asarray(c_single)
        print(f"tp {label} slice corr vs the single-device {label} kernel "
              f"path, not gated: min {c_single.min():.6f} median "
              f"{np.median(c_single):.6f}; per sample {fmt(c_single)}")
        if label == "float32":
            sample_gate("tp float32 slice", c_k, c_p,
                        [np.asarray(a) for a in k_moved])
        else:
            preset_gate("tp production slice", c_k, [c_p])
        tp[label] = (fn, plain_fn, sh32)
        del sh64, moved_sh
    del params64, moved_vit
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
         [np.asarray(c_pu)])
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
    # path of the same preset: production by the presets' gate
    # (preset_gate, against the plain float32 path as it is), float32 by
    # the per-sample rule that DeiT's and the methods' exact FP32 runs take
    # (sample_gate, the plain float32 path's corr the lower of two float32
    # draws): at 384 px exact FP32 is
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
             [np.asarray(c_moved)] if c_moved else [])
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
                                 "attn_last_layer", "attn_gradcam")] + [
        ("rollout", "production")]          # the non-kernel branch, bf16
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

    phase_mark("4, tensor parallel, checkpoints, 384 px and the harnesses")
    train_launches = training_phases(dev, tag, have, none)
    phase_mark("4, the training paths")
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

    def device_ms(fn, iters=50, yardstick=None):
        """(device ms a call, kernel names, {name: ms}) of ``fn``'s kernels
        by the profiler; fails where it sees none, except for a printed
        ``yardstick`` (its label), which then prints that it was not timed
        and gives None."""
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
        if not per and yardstick:
            print(f"  {yardstick}: the profiler saw no kernel of the call, "
                  f"so it is not timed (a yardstick, printed only)")
            return None
        require(per, "device_ms: the profiler saw no kernel of the call")
        return sum(per.values()), sorted(per), per

    b4_dev = device_ms(lambda: K.attn_fwd_core(qkv_main, h, hd, hd ** -0.5))
    sdpa_dev = device_ms(sdpa, yardstick="scaled_dot_product_attention f32")
    sdpa_txt = "not timed"
    if sdpa_dev:
        print(f"scaled_dot_product_attention f32 ran: "
              f"{'; '.join(sdpa_dev[1])}")
        sdpa_txt = f"{sdpa_dev[0]:.4f} ms"
    print(f"device time per call (profiler): B4 float32 {b4_dev[0]:.4f} ms, "
          f"scaled_dot_product_attention {sdpa_txt} {tag}")
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
        parts = [device_ms(lambda: torch.matmul(x_, y_), 20,
                           yardstick=f"torch.matmul bf16 for {name}")
                 for x_, y_ in pairs]
        k_dev = device_ms(lambda: getattr(K, name)(*tp_args[name]), 20)
        mm_txt = ("not timed" if None in parts else
                  f"{sum(p[0] for p in parts):.4f} ms ("
                  f"{', '.join(f'{p[0]:.4f}' for p in parts)})")
        print(f"time {name} {tp_shapes['main']} production modes: kernel "
              f"{times[name][0]:.4f} ms (events), {k_dev[0]:.4f} ms of "
              f"launches (profiler); torch.matmul bf16 on its five "
              f"products' bf16 operands, one call each: {mm_txt} (profiler) "
              f"{tag}")
    del x_mid, g_out, xn2, fc1, h1, hg, g_h1, Sr, fc1_b, hg2, R2, S1, b10_mm
    del block_inputs, bi, tp_inputs, ti, tp_args, qkv_main, q_, k_, v_
    tf32_t = tf32_times(tag, K, bm, tf32_inputs)
    del tf32_inputs
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
        mm = device_ms(lambda: torch.matmul(a16, b16), 20,
                       yardstick=f"torch.matmul bf16 for core {label}")
        mm_txt = (f"{mm[0]:.4f} ms a pass, "
                  f"{2.0 * rows * N_ * K_ / mm[0] / 1e9:.1f} TFLOP/s"
                  if mm else "not timed")
        print(f"time core {label} ({rows}, {N_}, {K_}) {mode}: kernel "
              f"{t_k:.4f} ms, {flop / t_k / 1e9:.1f} TFLOP/s of bf16 passes; "
              f"torch.matmul bf16 {mm_txt} (profiler) {tag}")
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
        mm = device_ms(lambda: torch.matmul(x16, y16), 20,
                       yardstick=f"torch.matmul bf16 for core B10 {kind}")
        flop = 2.0 * M_ * N_ * K_ * nprod
        mm_txt = (f"{mm[0]:.4f} ms a product, "
                  f"{2.0 * M_ * N_ * K_ / mm[0] / 1e9:.1f} TFLOP/s"
                  if mm else "not timed")
        print(f"time core B10 {kind} ({M_}, {N_}, {K_}) x{nprod} bfloat16: "
              f"kernel {t_k:.4f} ms, {flop / t_k / 1e9:.1f} TFLOP/s; "
              f"torch.matmul bf16 {mm_txt} (profiler) {tag}")
    del core_inputs, fused_inputs, a16, b16, x16, y16

    imgs_t = torch.as_tensor(batches[0][0], device=dev)
    idx_t = torch.as_tensor(batches[0][1], device=dev)

    def rate(ops, nb=RATE_BATCHES, model=None, imgs=None, **kw):
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
    print(f"e2e transformer_attribution ViT-B/16 f32 B=8, {RATE_BATCHES}-"
          f"batch windows: kernel path {r_kernel:.2f} / {r_kernel2:.2f} "
          f"expl/s, plain path {r_plain:.2f} expl/s, batch working memory "
          f"{peak:.3f} GiB {tag}")
    peak_p = peak_gib(K.KERNEL_OPS, **prod)
    rp_kernel = rate(K.KERNEL_OPS, **prod)
    rp_plain = rate(K.PLAIN_OPS, **prod)
    rp_kernel2 = rate(K.KERNEL_OPS, **prod)
    print(f"e2e transformer_attribution ViT-B/16 production B=8, "
          f"{RATE_BATCHES}-batch windows: kernel path {rp_kernel:.2f} / "
          f"{rp_kernel2:.2f} expl/s, plain path {rp_plain:.2f} expl/s, batch "
          f"working memory {peak_p:.3f} GiB {tag}")
    # the split path beside the megakernel path of the same preset, in
    # alternating windows: split kernels, split plain, megakernel, split
    # kernels, megakernel
    peak_s = peak_gib(K.KERNEL_OPS, **split)
    rs = [rate(K.KERNEL_OPS, **split), rate(K.PLAIN_OPS, **split),
          rate(K.KERNEL_OPS, **bf16), rate(K.KERNEL_OPS, **split),
          rate(K.KERNEL_OPS, **bf16)]
    print(f"e2e transformer_attribution ViT-B/16 bfloat16 split path "
          f"(block_kernel=False) B=8, {RATE_BATCHES}-batch windows: kernel "
          f"path {rs[0]:.2f} / {rs[3]:.2f} expl/s, plain path {rs[1]:.2f} "
          f"expl/s, batch working memory {peak_s:.3f} GiB; megakernel "
          f"bfloat16 path {rs[2]:.2f} / {rs[4]:.2f} expl/s {tag}")
    # raw tensorfloat32 on the megakernels and the tf32 split arm beside
    # the presets, in alternating windows, then each new path's plain path
    tf32_kw = {label: kw for label, (kw, _) in TF32_PATHS.items()}
    order = ["tensorfloat32", "tf32 split arm", "production", "bfloat16",
             "float32", "tensorfloat32", "tf32 split arm"]
    presets_kw = {"production": prod, "bfloat16": bf16, "float32": {}}
    rates_t = {}
    for label in order:
        rates_t.setdefault(label, []).append(
            rate(K.KERNEL_OPS, **{**presets_kw, **tf32_kw}[label]))
    for label, kw in tf32_kw.items():
        peak_t = peak_gib(K.KERNEL_OPS, **kw)
        r_plain = rate(K.PLAIN_OPS, nb=5, **kw)
        if label not in rates_t:
            rates_t[label] = [rate(K.KERNEL_OPS, **kw)]
        print(f"e2e transformer_attribution ViT-B/16 {label} B=8, "
              f"{RATE_BATCHES}-batch windows: kernel path "
              f"{' / '.join(f'{r:.2f}' for r in rates_t[label])} expl/s, "
              f"plain path {r_plain:.2f} expl/s (5-batch window), batch "
              f"working memory {peak_t:.3f} GiB {tag}")
    print("e2e transformer_attribution ViT-B/16 B=8 in the same windows: "
          + ", ".join(f"{label} {' / '.join(f'{r:.2f}' for r in rs_)} "
                      f"expl/s" for label, rs_ in rates_t.items())
          + f" {tag}")
    # each method in exact FP32, kernels (the rollout kernel, and B4/B5 on
    # the fused method's kernel branch)
    for m, variant, kw in method_runs:
        r = rate(K.KERNEL_OPS, method=m, variant=variant, **kw)
        print(f"e2e method {m} variant {variant} {kw} ViT-B/16 "
              f"float32 B=8, {RATE_BATCHES}-batch window: {r:.2f} expl/s "
              f"{tag}")
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
        print(f"e2e transformer_attribution {mname} {label} B=8, "
              f"{RATE_BATCHES}-batch windows: kernel path {r1:.2f} / "
              f"{r2:.2f} expl/s, plain path {r0:.2f} expl/s (5-batch "
              f"window), batch working memory {peak_n:.3f} GiB {tag}")
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
              f"{RATE_BATCHES}-batch windows: kernel path {r1:.2f} / "
              f"{r2:.2f} expl/s, plain path {r0:.2f} expl/s (5-batch window), "
              f"batch working "
              f"memory {peak_n:.3f} GiB {tag}")
    del models384, imgs384_t
    torch.cuda.empty_cache()

    def tp_rate(fn, sh, nb=RATE_BATCHES):
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
              f"{label} B=8, {RATE_BATCHES}-batch windows: kernel path "
              f"{r1:.2f} / {r2:.2f} expl/s, plain path {r0:.2f} expl/s {tag}")
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
    sdpa_m_dev = device_ms(sdpa_m, yardstick="scaled_dot_product_attention "
                           "with the additive mask")
    sdpa_m_txt = (f"{sdpa_m_dev[0]:.4f} ms (profiler), ran: "
                  f"{'; '.join(sdpa_m_dev[1])}" if sdpa_m_dev
                  else "not timed by the profiler")
    print(f"time B7 attention core (8, {qb.shape[2]}, {hb}, {hdb}) f32: launch "
          f"{core_ms:.4f} ms (profiler); scaled_dot_product_attention with "
          f"the additive mask {sdpa_m_ms:.4f} ms (events), {sdpa_m_txt} "
          f"{tag}")
    print("B7 launches (profiler, ms per call): " + "; ".join(
        f"{name[:60]} {ms:.4f}" for name, ms in sorted(
            b7_launches.items(), key=lambda kv: -kv[1])) + f" {tag}")
    del qkv_b, qb, kb, vb, mask4
    del bert_inputs, bi
    torch.cuda.empty_cache()

    def bert_rate(S, ops, nb=RATE_BATCHES, **kw):
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
                  f"{RATE_BATCHES}-batch windows: kernel path {r1:.2f} / "
                  f"{r2:.2f} expl/s, plain path {r0:.2f} expl/s {tag}")
    # each BERT method in exact FP32 (the rollout kernel where the method
    # rolls out)
    for m, variant, kw in bert_method_runs:
        r = bert_rate(512, K.BERT_KERNEL_OPS, method=m, variant=variant, **kw)
        print(f"e2e bert method {m} variant {variant} {kw} BERT-base float32 "
              f"B=8 S=512, {RATE_BATCHES}-batch window: {r:.2f} expl/s {tag}")

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
    phase_mark("5, times")
    tf32_names = {"attn_fwd_core": "attn_fwd.cuh",
                  "attn_rev_core": "attn_rev.cu",
                  "block_fwd_core": "block_fwd.cu",
                  "block_rev_core": "block_rev.cu"}
    tf32_entries = [
        {"name": f"{name} (tensorfloat32)", "route": "cuda",
         "source": f"transformer_explainability_torch/csrc/{src}",
         "replaces": f"{TPU_KERNELS}:{tpu_lines[name]}",
         "launches": sum(c[name] for c in tf32_launches.values()),
         "max_abs_err": tf32_errs[name],
         "ms": tf32_t[name][0], "plain_ms": tf32_t[name][1],
         "bound_ms": tf32_t[name][2], "bound_by": tf32_t[name][3],
         "library_ms": tf32_t[name][4]}
        for name, src in tf32_names.items()]
    slices = (launches, launches_prod, launches_split, launches_bf16,
              launches_diag, launches_mlp, *method_launches, *new_launches,
              blaunches, blaunches_prod, *bert_method_launches,
              *tp_launches, *ckpt_launches, *launches384,
              *harness_launches, *train_launches, *reduced_launches,
              *tf32_launches.values(), *guarded_launches)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"transformer_explainability_torch/csrc/{sources[name]}",
         "replaces": f"{TPU_KERNELS}:{tpu_lines[name]}",
         "launches": sum(c[name] for c in slices),
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library[name]}
        for name in sources] + tf32_entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
