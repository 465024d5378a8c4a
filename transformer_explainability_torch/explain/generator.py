"""Explanation entry points of the port: the ViT methods.

Port of ``transformer_explainability_tpu/explain/generator.py``: every
method of :data:`METHODS` (the reference's ``LRP.generate_LRP`` methods and
its ``Baselines``), the rule variants ``ours`` and ``lrp``, any α, and the
precision presets ``float32`` (exact FP32), ``production`` and ``bfloat16``
(:data:`PRECISION_PRESETS`, :func:`precision_kwargs`). JAX's kernel gate
decides the branch of :mod:`..models.vit`:

  * ``transformer_attribution`` (and its alias ``grad``) with variant
    ``ours`` at α=1 and no rule or MLP island above the base take the
    kernel branch: the forward with the attention core in
    ``attn_fwd_core`` (float32, with the attention island's mode; the
    bfloat16 and tensorfloat32 bases with ``block_kernel=False``) or whole
    blocks in ``block_fwd_core``; the reverse with ``attn_rev_core`` (and
    ``mlp_rev_core`` on the bfloat16 split path, the plain MLP arm on the
    tensorfloat32 one) or ``block_rev_core``, each block emitting its
    head-mean ``(grad ⊙ cam)⁺`` map; the ``rollout_from_grad_cam`` kernel
    chains the maps. Every attention and rule mode JAX's kernels run has a
    kernel instance, the bf16×3 ``tensorfloat32`` products among them;
  * every other method and option takes the non-kernel branch, at any
    base and with any islands, its products in the modes of JAX's lowered
    program (:mod:`..models.vit`), with the rollout kernel where the method
    rolls out.

The patch embedding is an exact product in every preset; on the kernel
branch the head is too, on the non-kernel branch it runs at the base, as
in JAX (float32 on a card needs TF32 off).
``mlp_fwd_precision`` / ``mlp_bwd_precision`` split ``mlp_precision``
between the forward's MLP products and the reverse's (JAX's split); with
``with_diagnostics`` the fused method also returns the :data:`DIAG_FIELDS`
vector of each sample.

The JAX package jit-compiles one program per configuration and pads
batches to power-of-two buckets; here PyTorch runs eagerly, the batch is
the leading dimension, and any batch size runs as it is.

The BERT layer kernels and the tensor-parallel program take no bf16×3
attention or rule products yet: their entry points raise
``NotImplementedError`` for them, naming "ROADMAP B, raw tensorfloat32
(BERT)" and "(TP)" (:func:`check_precision`).

The guarded mode (JAX's "production-guarded"): :func:`make_guarded_explain_fn`
runs the ``production`` program and checks each sample, in ``"strict"`` mode
against the exact-FP32 program on the same device, in ``"envelope"`` mode
against a trust region of its :data:`DIAG_FIELDS`; flagged samples are re-run
by :func:`make_cpu_exact_fn`, the exact program on the host CPU. The
thresholds keep JAX's values (:data:`STRICT_AGREEMENT`,
:data:`ENVELOPE_BOUNDS`), which were calibrated on a TPU with JAX's seed-0
weights: defaults to recalibrate per deployment
(:func:`calibrate_envelope`), not figures of the card.
"""

from __future__ import annotations

import threading
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from transformer_explainability_torch.models import vit as vit_mod
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as prec

Tensor = torch.Tensor

# method name -> needs (attention gradients, relevance chain) (JAX
# generator.METHODS); each method's output is documented at explain_batch
METHODS = {
    "transformer_attribution": (True, True),
    "grad": (True, True),                    # alias of the above
    "rollout": (False, True),                # relevance-cam rollout
    "full": (False, True),                   # full LRP to the pixels
    "last_layer": (False, True),             # + gradients with is_ablation
    "last_layer_attn": (False, False),       # raw attention
    "second_layer": (False, True),
    "attn_gradcam": (True, False),           # Baselines.generate_cam_attn
    "rollout_attn": (False, False),          # Baselines.generate_rollout
}
# the methods whose reverse folds (grad ⊙ cam)⁺ into each block
FUSED_METHODS = ("transformer_attribution", "grad")

# Per-sample stability statistics of with_diagnostics=True, in order (JAX
# generator.DIAG_FIELDS; the guarded mode's detector reads them):
#   r_sum, r_l1        — Σ R_tokens (the conservation readout) and Σ|R_tokens|;
#   gc_l1max, gc_max   — max over blocks of Σ|gc| and the largest |gc| entry
#                        of the per-block (grad ⊙ cam)⁺ head-mean maps;
#   heat_l1, heat_max  — the returned heatmap's Σ|·| and max|·|;
#   g_growth, g_l1max  — max/min over blocks of the gradient carry's |g|_inf,
#                        and its largest |g|_1;
#   R_growth, R_l1max  — the same for the relevance carry.
DIAG_FIELDS = ("r_sum", "r_l1", "gc_l1max", "gc_max", "heat_l1", "heat_max",
               "g_growth", "g_l1max", "R_growth", "R_l1max")
_DIAG_TINY = 1e-30            # the growth ratios' floor, in float32

# Named precision presets (JAX generator.PRECISION_PRESETS). "float32" is
# exact FP32; "production" and "bfloat16" run the block megakernels with
# "tensorfloat32" meaning the bf16×3 split and "bfloat16" one bf16 pass, as
# the JAX package defines them (ops/precision.py); so does the raw
# "tensorfloat32" of precision_kwargs.
PRECISION_PRESETS = {
    "float32": dict(matmul_precision="float32"),
    "production": dict(matmul_precision="tensorfloat32",
                       relprop_precision="bfloat16",
                       attn_precision="float32",
                       mlp_precision="bfloat16"),
    "bfloat16": dict(matmul_precision="bfloat16"),
}


def precision_kwargs(preset: str) -> dict:
    """A named preset (or the raw ``"tensorfloat32"``) -> the precision
    keyword arguments of :class:`Explainer` / :func:`make_explain_fn` (JAX
    ``generator.precision_kwargs``)."""
    if preset in PRECISION_PRESETS:
        return dict(PRECISION_PRESETS[preset])
    if preset == "tensorfloat32":
        return dict(matmul_precision=preset)
    raise ValueError(f"unknown precision preset {preset!r}; "
                     f"available: {sorted(PRECISION_PRESETS)}")


PREPROCESS_MEAN = (0.5, 0.5, 0.5)
PREPROCESS_STD = (0.5, 0.5, 0.5)


def preprocess_uint8(img_bhwc: Tensor, mean: tuple = PREPROCESS_MEAN,
                     std: tuple = PREPROCESS_STD) -> Tensor:
    """``(B, H, W, C)`` uint8 -> normalised ``(B, C, H, W)`` float32 (JAX
    ``generator.preprocess_uint8``)."""
    x = img_bhwc.to(torch.float32) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)


def _one_hot_index(logits: Tensor, index: Tensor, num_classes: int) -> Tensor:
    """index >= 0 -> that class; index < 0 -> the argmax of the logits
    (JAX ``generator._one_hot_index``)."""
    idx = torch.where(index >= 0, index, logits.argmax(dim=-1))
    return torch.nn.functional.one_hot(idx, num_classes).to(logits.dtype)


def mlp_split(mlp_precision: Optional[str] = None,
              mlp_fwd_precision: Optional[str] = None,
              mlp_bwd_precision: Optional[str] = None
              ) -> Tuple[Optional[str], Optional[str]]:
    """``(forward, reverse)`` MLP precisions: each of ``mlp_fwd_precision``
    and ``mlp_bwd_precision`` defaults to ``mlp_precision`` (JAX
    ``generator._explain_single_impl``). On the megakernel path they are
    independent: B2 forms the ``fc1_pre`` / ``fc2_pre`` anchors in the
    forward mode and B3 consumes them, running its MLP gradient products in
    the reverse mode."""
    return (mlp_precision if mlp_fwd_precision is None else mlp_fwd_precision,
            mlp_precision if mlp_bwd_precision is None else mlp_bwd_precision)


def uses_kernel_branch(method: str, alpha: float = 1.0,
                       variant: str = "ours",
                       matmul_precision: str = "float32",
                       relprop_precision: Optional[str] = None,
                       mlp_fwd_precision: Optional[str] = None,
                       mlp_bwd_precision: Optional[str] = None) -> bool:
    """JAX's kernel gate (``generator._explain_single_impl``): the fused
    method with variant ``ours`` at α=1 takes the kernel branch, unless a
    rule or MLP island asks for more than the base (the kernels' prepared
    weights cannot serve it; the whole program then takes the non-kernel
    branch)."""
    return (method in FUSED_METHODS and variant == "ours" and alpha == 1.0
            and not prec.islands_exceed_base(
                matmul_precision, relprop_precision, mlp_fwd_precision,
                mlp_bwd_precision))


def check_supported(method: str = "transformer_attribution",
                    alpha: float = 1.0, variant: str = "ours",
                    matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    with_diagnostics: bool = False,
                    block_kernel: bool = True,
                    mlp_fwd_precision: Optional[str] = None,
                    mlp_bwd_precision: Optional[str] = None) -> None:
    """Raise for every configuration the port does not run."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(METHODS)}")
    if variant not in ("ours", "lrp"):
        raise ValueError(f"unknown variant {variant!r} ('ours' or 'lrp')")
    if with_diagnostics and method not in FUSED_METHODS:
        raise ValueError("with_diagnostics is defined for the "
                         "transformer_attribution method only")
    _check_names(matmul_precision, relprop_precision, attn_precision,
                 mlp_precision, mlp_fwd_precision, mlp_bwd_precision)
    mlp_fwd, mlp_bwd = mlp_split(mlp_precision, mlp_fwd_precision,
                                 mlp_bwd_precision)
    if uses_kernel_branch(method, alpha, variant, matmul_precision,
                          relprop_precision, mlp_fwd, mlp_bwd):
        check_precision(matmul_precision, relprop_precision, attn_precision,
                        mlp_precision, block_kernel, mlp_fwd_precision,
                        mlp_bwd_precision)


def _check_names(*precisions: Optional[str]) -> None:
    for p in precisions:
        if p is not None and p not in prec.MODES:
            raise ValueError(f"unknown precision {p!r}; available: "
                             f"{list(prec.MODES)}")


def check_precision(matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    block_kernel: bool = True,
                    mlp_fwd_precision: Optional[str] = None,
                    mlp_bwd_precision: Optional[str] = None,
                    family: str = "vit") -> None:
    """The kernel modes a kernel path of ``family`` needs (JAX
    generator.py, vit.py). ``"vit"``: every configuration JAX's ViT kernel
    branch runs has its kernels (the float32 base's ``step_lite`` /
    ``kstep`` with B4 and B5 in the attention and rule islands' modes; the
    megakernels B2 / B3 at the bfloat16 and tensorfloat32 bases; the split
    path, ``block_kernel=False``, with B4, B5 and B6 at bfloat16 and B4, B5
    and the plain MLP arm at tensorfloat32), so only the names are
    checked. ``"bert"`` (the layer kernels B7-B9 at a reduced base) and
    ``"tp"`` (the tensor-parallel program's B4 / B5 and B10a / B10b) run no
    bf16×3 attention or rule products yet: a ``tensorfloat32`` attention or
    rule mode raises naming its ROADMAP B item. A rule or MLP island above
    a reduced base is not the kernel branch's (:func:`uses_kernel_branch`)
    and passes here."""
    mlp_fwd, mlp_bwd = mlp_split(mlp_precision, mlp_fwd_precision,
                                 mlp_bwd_precision)
    _check_names(matmul_precision, relprop_precision, attn_precision,
                 mlp_precision, mlp_fwd, mlp_bwd)
    if family not in ("vit", "bert", "tp"):
        raise ValueError(f"unknown model family {family!r}")
    if family == "vit" or prec.islands_exceed_base(
            matmul_precision, relprop_precision, mlp_fwd, mlp_bwd):
        return
    rule = prec.mxu_name(relprop_precision, matmul_precision)
    attn = prec.mxu_name(attn_precision, matmul_precision)
    if "tensorfloat32" in (rule, attn):
        raise NotImplementedError(
            f"tensorfloat32 rule or attention products have no "
            f"{'BERT layer' if family == 'bert' else 'tensor-parallel'} "
            f"kernel instantiation yet (ROADMAP B, raw tensorfloat32 "
            f"({family.upper()}))")


def _check_fp32_matmul(device: torch.device, dtype: torch.dtype) -> None:
    if (device.type == "cuda" and dtype == torch.float32
            and (torch.backends.cuda.matmul.allow_tf32
                 or torch.get_float32_matmul_precision() != "highest")):
        raise RuntimeError(
            "exact float32 needs TF32 off: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _diag_vector(R_tokens: Tensor, gc: Tensor, heat: Tensor,
                 trunk: Tensor) -> Tensor:
    """The :data:`DIAG_FIELDS` of each sample, ``(B, 10)`` float32 (JAX
    ``generator._diag_vector``), from the block-0 relevance ``(B, n, D)``,
    the per-block maps ``(B, L, n, n)``, the heatmap and the float32 trunk
    statistics ``(B, L, 4)``; PyTorch reductions outside the kernels. As in
    JAX the growth ratios are formed in float32, the rest in the tensors'
    dtype, and every field is rounded to float32 once."""
    R = R_tokens.flatten(1)
    gc_abs = gc.abs()
    heat_abs = heat.abs().flatten(1)
    g_inf, g_l1, R_inf, R_l1 = trunk.unbind(dim=-1)          # (B, L) each
    fields = [R.sum(1), R.abs().sum(1),
              gc_abs.sum(dim=(2, 3)).amax(1), gc_abs.flatten(1).amax(1),
              heat_abs.sum(1), heat_abs.amax(1),
              g_inf.amax(1) / g_inf.amin(1).clamp(min=_DIAG_TINY),
              g_l1.amax(1),
              R_inf.amax(1) / R_inf.amin(1).clamp(min=_DIAG_TINY),
              R_l1.amax(1)]
    return torch.stack([f.to(torch.float32) for f in fields], dim=1)


@torch.no_grad()
def explain_batch(model: vit_mod.VisionTransformer, images: Tensor,
                  indices: Tensor, start_layer: int = 0,
                  method: str = "transformer_attribution",
                  ops: K.AttnOps = K.KERNEL_OPS,
                  matmul_precision: str = "float32",
                  relprop_precision: Optional[str] = None,
                  attn_precision: Optional[str] = None,
                  mlp_precision: Optional[str] = None,
                  is_ablation: bool = False, alpha: float = 1.0,
                  variant: str = "ours", block_kernel: bool = True,
                  mlp_fwd_precision: Optional[str] = None,
                  mlp_bwd_precision: Optional[str] = None,
                  with_diagnostics: bool = False):
    """Batched explanation (JAX ``generator.explain_single`` vmapped):
    ``images (B, C, H, W)`` in the model's dtype and device, ``indices
    (B,)`` int64 with −1 for the argmax class. Returns, per method (JAX's
    shapes with a leading batch dimension): the CLS-row relevance over the
    patches ``(B, num_patches)``; ``full`` the pixel relevance ``(B, H, W)``;
    ``attn_gradcam`` a ``(B, grid, grid)`` map min-max normalised per sample.
    ``ops`` selects the kernels (default) or, for a reference run, their
    plain versions; the precision arguments are those of
    :data:`PRECISION_PRESETS`, ``mlp_fwd_precision`` / ``mlp_bwd_precision``
    overriding ``mlp_precision`` on one side (:func:`mlp_split`);
    ``block_kernel=False`` takes the split path at the bfloat16 and
    tensorfloat32 bases (JAX's ``TE_TPU_NO_BLOCK_KERNEL=1``).
    ``with_diagnostics`` (the fused method only) returns ``(heat, diag (B,
    10))``, ``diag`` the float32 :data:`DIAG_FIELDS` of each sample; the
    heatmap is the same bit for bit."""
    check_supported(method, alpha, variant, matmul_precision,
                    relprop_precision, attn_precision, mlp_precision,
                    with_diagnostics, block_kernel, mlp_fwd_precision,
                    mlp_bwd_precision)
    mlp_fwd, mlp_bwd = mlp_split(mlp_precision, mlp_fwd_precision,
                                 mlp_bwd_precision)
    cfg = model.cfg
    _check_fp32_matmul(images.device, images.dtype)
    needs_grads = METHODS[method][0] or (
        is_ablation and method in ("last_layer", "second_layer"))
    needs_relprop = METHODS[method][1]
    fused = method in FUSED_METHODS
    kernel = uses_kernel_branch(method, alpha, variant, matmul_precision,
                                relprop_precision, mlp_fwd, mlp_bwd)
    branch = dict(use_attn_kernel=kernel, block_kernel=block_kernel,
                  matmul_precision=matmul_precision,
                  attn_precision=attn_precision)
    logits, res = vit_mod.forward_collect(model, images, ops,
                                          mlp_precision=mlp_fwd, **branch)
    R_tokens = cams = grads = trunk = None
    if needs_grads or needs_relprop:
        onehot = _one_hot_index(logits, indices, cfg.num_classes)
        R_tokens, cams, grads, *stats = vit_mod.reverse_pass(
            model, res, onehot, alpha, variant, ops,
            relprop_precision=relprop_precision, mlp_precision=mlp_bwd,
            need_grads=needs_grads, need_relprop=needs_relprop,
            fuse_grad_cam=fused, with_trunk_stats=with_diagnostics,
            **branch)
        trunk = stats[0] if stats else None
    P = cfg.num_prefix_tokens
    if fused or method == "rollout":
        heat = ops.rollout_from_grad_cam(cams, start_layer, rows=1)[:, 0, P:]
        if with_diagnostics:
            return heat, _diag_vector(R_tokens, cams, heat, trunk)
        return heat
    if method == "full":
        return vit_mod.full_lrp_input_relevance(model, res, R_tokens, images,
                                                variant, matmul_precision)
    if method in ("last_layer", "second_layer"):
        li = cfg.depth - 1 if method == "last_layer" else 1
        cam = cams[:, li]
        if is_ablation:
            cam = grads[:, li] * cam
        return cam.clamp(min=0).mean(dim=1)[:, 0, P:]
    if method == "last_layer_attn":
        return res.attns[:, -1].clamp(min=0).mean(dim=1)[:, 0, P:]
    if method == "attn_gradcam":
        # GradCAM on the last attention map, per head, min-max normalised
        g, B = cfg.grid, images.shape[0]
        cam = res.attns[:, -1, :, 0, P:].reshape(B, -1, g, g)
        grad = grads[:, -1, :, 0, P:].reshape(B, -1, g, g)
        cam = (cam * grad.mean(dim=(2, 3), keepdim=True)).mean(dim=1)
        cam = cam.clamp(min=0)
        lo = cam.amin(dim=(1, 2), keepdim=True)
        return (cam - lo) / (cam.amax(dim=(1, 2), keepdim=True) - lo)
    # rollout_attn: the raw-attention rollout, row-normalised
    return ops.rollout_from_grad_cam(res.attns, start_layer,
                                     row_normalize=True, rows=1)[:, 0, P:]


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available")
    return device


def make_explain_fn(cfg: ViTConfig, device,
                    method: str = "transformer_attribution",
                    start_layer: int = 0, is_ablation: bool = False,
                    alpha: float = 1.0, variant: str = "ours",
                    matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    mlp_fwd_precision: Optional[str] = None,
                    mlp_bwd_precision: Optional[str] = None,
                    with_diagnostics: bool = False,
                    preprocess: Optional[str] = None,
                    block_kernel: bool = True) -> Callable:
    """Build ``fn(model, images, indices) -> heatmaps`` (JAX
    ``generator.make_explain_fn``), shaped per method as
    :func:`explain_batch` (with ``with_diagnostics``, ``(heatmaps, diag)``).
    ``images`` are ``(B, C, H, W)``, or raw ``(B, H, W, C)`` uint8 frames
    with ``preprocess="uint8"``; ``indices (B,)``, −1 for the argmax class.
    Inputs may be numpy arrays or tensors; they are moved to ``device`` and
    the model's dtype."""
    check_supported(method, alpha, variant, matmul_precision,
                    relprop_precision, attn_precision, mlp_precision,
                    with_diagnostics, block_kernel, mlp_fwd_precision,
                    mlp_bwd_precision)
    if preprocess not in (None, "uint8"):
        raise ValueError(f"unknown preprocess {preprocess!r} "
                         "(None or 'uint8')")
    device = _resolve_device(device)
    kw = dict(matmul_precision=matmul_precision,
              relprop_precision=relprop_precision,
              attn_precision=attn_precision, mlp_precision=mlp_precision,
              mlp_fwd_precision=mlp_fwd_precision,
              mlp_bwd_precision=mlp_bwd_precision,
              with_diagnostics=with_diagnostics,
              is_ablation=is_ablation, alpha=alpha, variant=variant,
              block_kernel=block_kernel)

    def fn(model: vit_mod.VisionTransformer, images, indices):
        if model.cfg != cfg:
            raise ValueError("model config differs from the explain fn's")
        dtype = model.cls_token.dtype
        images = torch.as_tensor(images, device=device)
        if preprocess == "uint8":
            images = preprocess_uint8(images)
        images = images.to(dtype)
        idx = torch.as_tensor(indices, device=device).to(torch.int64)
        return explain_batch(model, images, idx.reshape(images.shape[0]),
                             start_layer, method, **kw)

    return fn


# ---------------------------------------------------------------------------
# The guarded mode: checked serving with an exact-CPU fallback
# ---------------------------------------------------------------------------

# Host-side scores over the DIAG_FIELDS vector, larger = more suspicious
# (JAX generator.CHAOS_STATS; JAX measured that none of them separates the
# sub-0.999 band within an input class: they serve the envelope detector)
CHAOS_STATS = {
    "r_drift": lambda d: np.abs(d[:, 0] - 1.0),
    "r_l1": lambda d: d[:, 1],
    "r_cancel": lambda d: d[:, 1] / np.maximum(np.abs(d[:, 0]), 1e-9),
    "gc_l1max": lambda d: d[:, 2],
    "gc_max": lambda d: d[:, 3],
    "heat_l1": lambda d: d[:, 4],
    "heat_max": lambda d: d[:, 5],
    "g_growth": lambda d: d[:, 6],
    "g_l1max": lambda d: d[:, 7],
    "R_growth": lambda d: d[:, 8],
    "R_l1max": lambda d: d[:, 9],
}

# The "envelope" mode's trust region, a [lo, hi] per DIAG_FIELD (JAX
# generator.ENVELOPE_BOUNDS, the same values so that on the same
# diagnostics the port flags what JAX flags): calibrated by JAX on a TPU
# with its seed-0 weights on 160 augments of one image at a x1.3 margin.
# They are the defaults, not figures of the card; recalibrate on the
# deployment's known-good traffic with calibrate_envelope.
ENVELOPE_BOUNDS = {
    "r_sum": (0.597854, 1.34563),
    "r_l1": (1.13319, 65.1951),
    "gc_l1max": (5.45804e-05, 0.0134388),
    "gc_max": (4.27658e-07, 0.00015762),
    "heat_l1": (0.000156718, 0.0140936),
    "heat_max": (1.0612e-06, 0.000160642),
    "g_growth": (3.49377, 30.044),
    "g_l1max": (71.3786, 802.741),
    "R_growth": (1.14703, 129.423),
    "R_l1max": (1.1677, 351.321),
}

# The "strict" mode's threshold: a sample whose production and exact-FP32
# heatmaps correlate below it is flagged (JAX generator.STRICT_AGREEMENT,
# tuned by JAX on 161 TPU-measured samples; a default here too)
STRICT_AGREEMENT = 0.9999


def calibrate_envelope(diag: np.ndarray, margin: float = 1.3) -> dict:
    """Trust-region bounds from the ``(N, len(DIAG_FIELDS))`` diagnostics of
    known-good traffic (the ``with_diagnostics`` program's), each field's
    [min, max] widened by ``margin`` multiplicatively (JAX
    ``generator.calibrate_envelope``)."""
    diag = np.asarray(diag, np.float64)
    out = {}
    for k, f in enumerate(DIAG_FIELDS):
        lo, hi = float(diag[:, k].min()), float(diag[:, k].max())
        out[f] = (lo - (margin - 1.0) * abs(lo),
                  hi + (margin - 1.0) * abs(hi))
    return out


def _envelope_flags(diag: np.ndarray, bounds: dict) -> np.ndarray:
    """A sample is flagged where any field leaves its bounds."""
    diag = np.asarray(diag, np.float64)
    flagged = np.zeros(diag.shape[0], bool)
    for k, f in enumerate(DIAG_FIELDS):
        lo, hi = bounds[f]
        flagged |= (diag[:, k] < lo) | (diag[:, k] > hi)
    return flagged


def _batch_corr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row Pearson correlation, in float64."""
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    a = a - a.mean(axis=1, keepdims=True)
    b = b - b.mean(axis=1, keepdims=True)
    num = (a * b).sum(axis=1)
    den = np.sqrt((a * a).sum(axis=1) * (b * b).sum(axis=1))
    return num / np.maximum(den, 1e-300)


def _guard_flags(mode: str, heat: np.ndarray, other: np.ndarray,
                 agreement: Optional[float] = None,
                 bounds: Optional[dict] = None,
                 n_valid: Optional[int] = None) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """The guard's decision on one batch, on the host: ``other`` is the
    exact-FP32 program's heatmaps (``mode="strict"``: the score is their
    corr with ``heat``, flagged below ``agreement``) or the diagnostics
    (``"envelope"``: flagged outside ``bounds``, the score ``g_growth``,
    column 6). Rows from ``n_valid`` on are padding and never flagged.
    Returns ``(flagged, score)``."""
    if mode == "strict":
        score = _batch_corr(heat, other)
        flagged = score < agreement
    else:
        diag = np.asarray(other, np.float64)
        flagged = _envelope_flags(diag, bounds)
        score = diag[:, 6]
    if n_valid is not None:
        flagged &= np.arange(len(flagged)) < n_valid
    return flagged, score


def _to_host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array of its own."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _weights_key(model: torch.nn.Module) -> tuple:
    """What a CPU copy of ``model`` was made from: each tensor's storage and
    version (an in-place change, ``load_state_dict`` among them, moves it)."""
    return tuple((t.data_ptr(), t._version)
                 for t in model.state_dict().values())


def cpu_exact_cache(make_model: Callable) -> Callable:
    """``copy(model)``: a CPU copy of ``model`` made by ``make_model(dtype)``,
    kept for the next call with the same model. The cache is filled under a
    lock (a server calls from two threads) and keyed on the model's identity
    with a strong reference to it, so that a recycled ``id`` can never give
    another model's weights, and on :func:`_weights_key`, so that weights
    changed in place are copied again (JAX's ``make_cpu_exact_fn`` cache)."""
    state = {}
    lock = threading.Lock()

    def copy(model):
        with lock:
            key = _weights_key(model)
            if state.get("src") is not model or state.get("key") != key:
                sd = {k: v.detach().to("cpu")
                      for k, v in model.state_dict().items()}
                dtype = next(v.dtype for v in sd.values()
                             if v.is_floating_point())
                cpu_model = make_model(dtype)
                cpu_model.load_state_dict(sd)
                cpu_model.requires_grad_(False)
                state.update(model=cpu_model, src=model, key=key)
            copy.calls += 1
            return state["model"]

    copy.calls = 0         # the copies asked for: one a call of the caller
    return copy


def make_cpu_exact_fn(cfg: ViTConfig, start_layer: int = 0,
                      matmul_precision: str = "float32",
                      preprocess: Optional[str] = None) -> Callable:
    """One-sample exact ``transformer_attribution`` on the host CPU: the
    guarded mode's last tier (JAX ``generator.make_cpu_exact_fn``). Returns
    ``fn(model, img, index) -> heatmap`` (numpy), ``img`` one ``(C, H, W)``
    image (or one ``(H, W, C)`` uint8 frame with ``preprocess="uint8"``) on
    any device. It runs the port's plain path on a CPU copy of ``model`` in
    the model's dtype (no kernel runs on the CPU), pinned to
    ``torch.device("cpu")`` whatever device the model is on; the copy is
    cached (:func:`cpu_exact_cache`) and the call runs outside its lock.
    ``fn.copy.calls`` counts the calls."""
    cpu = torch.device("cpu")
    explain = make_explain_fn(cfg, cpu, start_layer=start_layer,
                              matmul_precision=matmul_precision,
                              preprocess=preprocess, block_kernel=False)
    copy = cpu_exact_cache(lambda dtype: vit_mod.VisionTransformer(
        cfg, device=cpu, dtype=dtype))

    def fn(model: vit_mod.VisionTransformer, img, index) -> np.ndarray:
        cpu_model = copy(model)
        img = torch.as_tensor(img).detach().to(cpu)[None]
        idx = torch.as_tensor(index).detach().to(cpu).reshape(1)
        return explain(cpu_model, img, idx)[0].numpy()

    fn.copy = copy
    return fn


def make_guarded_explain_fn(cfg: ViTConfig, device, start_layer: int = 0,
                            mode: str = "strict",
                            agreement: Optional[float] = None,
                            envelope_bounds: Optional[dict] = None,
                            fallback_precision: str = "float32",
                            fallback: str = "sync",
                            return_info: bool = False,
                            preprocess: Optional[str] = None,
                            **precision_overrides) -> Callable:
    """The guarded ``production`` mode (JAX
    ``generator.make_guarded_explain_fn``): the ``production`` program on
    ``device`` with a per-sample check.

      * ``mode="strict"``: the exact-FP32 program runs beside it on the same
        device; a sample whose two heatmaps correlate below ``agreement``
        (default :data:`STRICT_AGREEMENT`) is flagged;
      * ``mode="envelope"``: ``production`` with ``with_diagnostics``; a
        sample whose :data:`DIAG_FIELDS` leave ``envelope_bounds`` (default
        :data:`ENVELOPE_BOUNDS`) is flagged. An anomaly detector, not a
        per-sample guarantee.

    Returns ``fn(model, images, indices, n_valid=None) -> heatmaps``
    (numpy), or with ``return_info`` ``(heatmaps, {"flagged": bool (B,),
    "score": float (B,)})``: the score is the production-vs-FP32 corr in
    strict mode, the ``g_growth`` field (column 6) in envelope mode.
    ``n_valid`` marks the first n rows as real and the rest as padding,
    which is never flagged. ``fallback="sync"`` re-runs flagged rows by
    :func:`make_cpu_exact_fn` (in ``fallback_precision``, ``fn.cpu_exact``)
    before returning; ``"defer"`` only marks them (the serving queue's
    policy, :mod:`.serving`). ``preprocess="uint8"`` (raw ``(B, H, W, C)``
    frames) reaches all three programs. ``precision_overrides`` are
    :func:`make_explain_fn` precision arguments over the ``production``
    preset, for the fast program."""
    if mode not in ("strict", "envelope"):
        raise ValueError(f"unknown guarded mode {mode!r}")
    if fallback not in ("sync", "defer"):
        raise ValueError(f"unknown fallback policy {fallback!r}")
    kwargs = dict(PRECISION_PRESETS["production"], **precision_overrides)
    device = _resolve_device(device)
    bounds = None
    if mode == "strict":
        agreement = STRICT_AGREEMENT if agreement is None else agreement
        fast = make_explain_fn(cfg, device, start_layer=start_layer,
                               preprocess=preprocess, **kwargs)
        verify = make_explain_fn(cfg, device, start_layer=start_layer,
                                 preprocess=preprocess)
    else:
        bounds = dict(envelope_bounds or ENVELOPE_BOUNDS)
        fast = make_explain_fn(cfg, device, start_layer=start_layer,
                               with_diagnostics=True, preprocess=preprocess,
                               **kwargs)
    cpu_exact = make_cpu_exact_fn(cfg, start_layer, fallback_precision,
                                  preprocess)

    def guarded(model: vit_mod.VisionTransformer, images, indices,
                n_valid: Optional[int] = None):
        if mode == "strict":
            heat_d, other_d = (fast(model, images, indices),
                               verify(model, images, indices))
        else:
            heat_d, other_d = fast(model, images, indices)
        heat = _to_host(heat_d)
        flagged, score = _guard_flags(mode, heat, _to_host(other_d),
                                      agreement, bounds, n_valid)
        if fallback == "sync":
            for i in np.flatnonzero(flagged):
                heat[i] = cpu_exact(model, images[i], indices[i])
        if return_info:
            return heat, {"flagged": flagged, "score": score}
        return heat

    guarded.cpu_exact = cpu_exact
    return guarded


class Explainer:
    """Convenience wrapper around a model built from ``params`` (a timm-named
    state dict, e.g. from :func:`..models.vit.init_params` or
    :func:`..params.convert.vit_params_from_jax`) on ``device``, in the
    params' dtype (JAX ``generator.Explainer``; the reference's ``LRP`` and
    ``Baselines``). The precision arguments are those of
    :data:`PRECISION_PRESETS`, e.g.
    ``Explainer(params, cfg, "cuda", **precision_kwargs("production"))``,
    and ``mlp_fwd_precision`` / ``mlp_bwd_precision``;
    ``block_kernel=False`` takes the split path at the bfloat16 and
    tensorfloat32 bases. Any
    :class:`..models.vit.ViTConfig` runs: ViT-B/16, ViT-L/16, DeiT-base and
    DeiT-base distilled."""

    def __init__(self, params: Mapping[str, Tensor], cfg: ViTConfig, device,
                 variant: str = "ours", matmul_precision: str = "float32",
                 relprop_precision=None, attn_precision=None,
                 mlp_precision=None, block_kernel: bool = True,
                 mlp_fwd_precision=None, mlp_bwd_precision=None):
        self.variant = variant
        self.precision = dict(matmul_precision=matmul_precision,
                              relprop_precision=relprop_precision,
                              attn_precision=attn_precision,
                              mlp_precision=mlp_precision,
                              block_kernel=block_kernel,
                              mlp_fwd_precision=mlp_fwd_precision,
                              mlp_bwd_precision=mlp_bwd_precision)
        # the method is the call's: each explain checks its own pair
        if variant not in ("ours", "lrp"):
            raise ValueError(f"unknown variant {variant!r} ('ours' or "
                             "'lrp')")
        _check_names(*(v for k, v in self.precision.items()
                       if k != "block_kernel"))
        self.device = _resolve_device(device)
        self.cfg = cfg
        dtype = params["cls_token"].dtype
        self.model = vit_mod.VisionTransformer(cfg, device=self.device,
                                               dtype=dtype)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False)

    def explain(self, images, indices=None,
                method: str = "transformer_attribution",
                start_layer: int = 0, is_ablation: bool = False,
                alpha: float = 1.0, with_diagnostics: bool = False):
        """``images (B, C, H, W)`` or one ``(C, H, W)``; ``indices`` per
        sample, −1 (or None for all) meaning the argmax class. Returns the
        method's maps (:func:`explain_batch`) on the explainer's device;
        with ``with_diagnostics``, ``(maps, diag (B, 10))``."""
        images = torch.as_tensor(images)
        if images.ndim == 3:
            images = images[None]
        B = images.shape[0]
        if indices is None:
            indices = torch.full((B,), -1, dtype=torch.int64)
        fn = make_explain_fn(self.cfg, self.device, method, start_layer,
                             is_ablation, alpha, self.variant,
                             with_diagnostics=with_diagnostics,
                             **self.precision)
        return fn(self.model, images, indices)

    # the reference Baselines API surface
    def generate_rollout(self, images, start_layer: int = 0) -> Tensor:
        return self.explain(images, method="rollout_attn",
                            start_layer=start_layer)

    def generate_cam_attn(self, images, indices=None) -> Tensor:
        return self.explain(images, indices, method="attn_gradcam")
