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
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

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
