"""Explanation entry points of the port: the ViT methods.

Port of ``transformer_explainability_tpu/explain/generator.py``: every
method of :data:`METHODS` (the reference's ``LRP.generate_LRP`` methods and
its ``Baselines``), the rule variants ``ours`` and ``lrp``, any α, and the
precision presets ``float32`` (exact FP32), ``production`` and ``bfloat16``
(:data:`PRECISION_PRESETS`, :func:`precision_kwargs`). JAX's kernel gate
decides the branch of :mod:`..models.vit`:

  * ``transformer_attribution`` (and its alias ``grad``) with variant
    ``ours`` at α=1 take the kernel branch: the forward with the attention
    core in ``attn_fwd_core`` (float32; bfloat16 with ``block_kernel=False``)
    or whole blocks in ``block_fwd_core``; the reverse with ``attn_rev_core``
    (and ``mlp_rev_core`` on the split path) or ``block_rev_core``, each
    block emitting its head-mean ``(grad ⊙ cam)⁺`` map; the
    ``rollout_from_grad_cam`` kernel chains the maps;
  * every other method and option takes the non-kernel branch, exact
    products at the float32 base, with the rollout kernel where the method
    rolls out.

In every preset the embedding, the final norm and the head are exact
products in the parameters' dtype (float32 on a card needs TF32 off).

The JAX package jit-compiles one program per configuration and pads
batches to power-of-two buckets; here PyTorch runs eagerly, the batch is
the leading dimension, and any batch size runs as it is.

The non-kernel branch at the reduced-precision bases, the tensorfloat32
split arm, the precision combinations the kernels do not run and
``with_diagnostics`` raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

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

# Named precision presets (JAX generator.PRECISION_PRESETS). "float32" is
# exact FP32; "production" and "bfloat16" run the block megakernels with
# "tensorfloat32" meaning the bf16×3 split and "bfloat16" one bf16 pass, as
# the JAX package defines them (ops/precision.py).
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


def uses_kernel_branch(method: str, alpha: float = 1.0,
                       variant: str = "ours") -> bool:
    """JAX's kernel gate (``generator._explain_single_impl``): the fused
    method with variant ``ours`` at α=1 takes the kernel branch."""
    return method in FUSED_METHODS and variant == "ours" and alpha == 1.0


def check_supported(method: str = "transformer_attribution",
                    alpha: float = 1.0, variant: str = "ours",
                    matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    with_diagnostics: bool = False,
                    block_kernel: bool = True) -> None:
    """Raise for every configuration the port does not run."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(METHODS)}")
    if variant not in ("ours", "lrp"):
        raise ValueError(f"unknown variant {variant!r} ('ours' or 'lrp')")
    check_precision(matmul_precision, relprop_precision, attn_precision,
                    mlp_precision, block_kernel)
    if (not uses_kernel_branch(method, alpha, variant)
            and matmul_precision != "float32"):
        raise NotImplementedError(
            f"method {method!r}, variant {variant!r}, alpha {alpha} take the "
            "non-kernel branch, which runs at the float32 base only: its "
            "products at other bases need a fidelity measurement on the card "
            "first (ROADMAP A4)")
    if with_diagnostics:
        raise NotImplementedError("with_diagnostics is not ported yet "
                                  "(ROADMAP A11)")


def check_precision(matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    block_kernel: bool = True) -> None:
    """The JAX gates of the kernel paths (generator.py, vit.py): float32
    runs the B4/B5 path with no islands; bfloat16 / tensorfloat32 run the
    block megakernels when no weight-consuming island exceeds the base, the
    rule products are bfloat16 and the attention's are float32 or
    bfloat16; with ``block_kernel=False`` the bfloat16 base runs the split
    path (B4, B5, B6) under the same island rules."""
    for p in (matmul_precision, relprop_precision, attn_precision,
              mlp_precision):
        if p is not None and p not in prec.MODES:
            raise ValueError(f"unknown precision {p!r}; available: "
                             f"{list(prec.MODES)}")
    islands = (relprop_precision, attn_precision, mlp_precision)
    if matmul_precision == "float32":
        if any(p is not None for p in islands):
            raise NotImplementedError("precision islands on the float32 "
                                      "base are not ported yet (ROADMAP A4)")
        return
    if prec.islands_exceed_base(matmul_precision, relprop_precision,
                                mlp_precision):
        raise NotImplementedError(
            "a rule or MLP precision above the base takes the non-kernel "
            "path, not ported yet (ROADMAP A4)")
    rule = prec.mxu_name(relprop_precision, matmul_precision)
    attn = prec.mxu_name(attn_precision, matmul_precision)
    if rule != "bfloat16" or attn == "tensorfloat32":
        raise NotImplementedError(
            "tensorfloat32 rule or attention products have no block-kernel "
            "instantiation yet (ROADMAP B, raw tensorfloat32)")
    if not block_kernel and matmul_precision != "bfloat16":
        raise NotImplementedError(
            "the split path (block_kernel=False) runs at the bfloat16 base; "
            "the tensorfloat32 split arm waits for an on-card fidelity "
            "measurement (ROADMAP B, the tf32 split arm)")


def _check_fp32_matmul(device: torch.device, dtype: torch.dtype) -> None:
    if (device.type == "cuda" and dtype == torch.float32
            and (torch.backends.cuda.matmul.allow_tf32
                 or torch.get_float32_matmul_precision() != "highest")):
        raise RuntimeError(
            "exact float32 needs TF32 off: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


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
                  variant: str = "ours", block_kernel: bool = True) -> Tensor:
    """Batched explanation (JAX ``generator.explain_single`` vmapped):
    ``images (B, C, H, W)`` in the model's dtype and device, ``indices
    (B,)`` int64 with −1 for the argmax class. Returns, per method (JAX's
    shapes with a leading batch dimension): the CLS-row relevance over the
    patches ``(B, num_patches)``; ``full`` the pixel relevance ``(B, H, W)``;
    ``attn_gradcam`` a ``(B, grid, grid)`` map min-max normalised per sample.
    ``ops`` selects the kernels (default) or, for a reference run, their
    plain versions; the precision arguments are those of
    :data:`PRECISION_PRESETS`; ``block_kernel=False`` takes the split path
    at the bfloat16 base (JAX's ``TE_TPU_NO_BLOCK_KERNEL=1``)."""
    precision = dict(matmul_precision=matmul_precision,
                     attn_precision=attn_precision,
                     mlp_precision=mlp_precision)
    check_supported(method, alpha, variant, relprop_precision=relprop_precision,
                    block_kernel=block_kernel, **precision)
    cfg = model.cfg
    _check_fp32_matmul(images.device, images.dtype)
    needs_grads = METHODS[method][0] or (
        is_ablation and method in ("last_layer", "second_layer"))
    needs_relprop = METHODS[method][1]
    fused = method in FUSED_METHODS
    kernel = uses_kernel_branch(method, alpha, variant)
    branch = dict(use_attn_kernel=kernel, block_kernel=block_kernel)
    logits, res = vit_mod.forward_collect(model, images, ops, **precision,
                                          **branch)
    R_tokens = cams = grads = None
    if needs_grads or needs_relprop:
        onehot = _one_hot_index(logits, indices, cfg.num_classes)
        R_tokens, cams, grads = vit_mod.reverse_pass(
            model, res, onehot, alpha, variant, ops,
            relprop_precision=relprop_precision, need_grads=needs_grads,
            need_relprop=needs_relprop, fuse_grad_cam=fused, **precision,
            **branch)
    P = cfg.num_prefix_tokens
    if fused or method == "rollout":
        return ops.rollout_from_grad_cam(cams, start_layer, rows=1)[:, 0, P:]
    if method == "full":
        return vit_mod.full_lrp_input_relevance(model, res, R_tokens, images,
                                                variant)
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
                    with_diagnostics: bool = False,
                    preprocess: Optional[str] = None,
                    block_kernel: bool = True) -> Callable:
    """Build ``fn(model, images, indices) -> heatmaps`` (JAX
    ``generator.make_explain_fn``), shaped per method as
    :func:`explain_batch`. ``images`` are ``(B, C, H, W)``, or raw
    ``(B, H, W, C)`` uint8 frames with ``preprocess="uint8"``;
    ``indices (B,)``, −1 for the argmax class. Inputs may be numpy arrays or
    tensors; they are moved to ``device`` and the model's dtype."""
    check_supported(method, alpha, variant, matmul_precision,
                    relprop_precision, attn_precision, mlp_precision,
                    with_diagnostics, block_kernel)
    if preprocess not in (None, "uint8"):
        raise ValueError(f"unknown preprocess {preprocess!r} "
                         "(None or 'uint8')")
    device = _resolve_device(device)
    kw = dict(matmul_precision=matmul_precision,
              relprop_precision=relprop_precision,
              attn_precision=attn_precision, mlp_precision=mlp_precision,
              is_ablation=is_ablation, alpha=alpha, variant=variant,
              block_kernel=block_kernel)

    def fn(model: vit_mod.VisionTransformer, images, indices) -> Tensor:
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
    ``Explainer(params, cfg, "cuda", **precision_kwargs("production"))``;
    ``block_kernel=False`` takes the split path at the bfloat16 base."""

    def __init__(self, params: Mapping[str, Tensor], cfg: ViTConfig, device,
                 variant: str = "ours", matmul_precision: str = "float32",
                 relprop_precision=None, attn_precision=None,
                 mlp_precision=None, block_kernel: bool = True):
        self.variant = variant
        self.precision = dict(matmul_precision=matmul_precision,
                              relprop_precision=relprop_precision,
                              attn_precision=attn_precision,
                              mlp_precision=mlp_precision,
                              block_kernel=block_kernel)
        check_supported(variant=variant, **self.precision)
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
                alpha: float = 1.0) -> Tensor:
        """``images (B, C, H, W)`` or one ``(C, H, W)``; ``indices`` per
        sample, −1 (or None for all) meaning the argmax class. Returns the
        method's maps (:func:`explain_batch`) on the explainer's device."""
        images = torch.as_tensor(images)
        if images.ndim == 3:
            images = images[None]
        B = images.shape[0]
        if indices is None:
            indices = torch.full((B,), -1, dtype=torch.int64)
        fn = make_explain_fn(self.cfg, self.device, method, start_layer,
                             is_ablation, alpha, self.variant,
                             **self.precision)
        return fn(self.model, images, indices)

    # the reference Baselines API surface
    def generate_rollout(self, images, start_layer: int = 0) -> Tensor:
        return self.explain(images, method="rollout_attn",
                            start_layer=start_layer)

    def generate_cam_attn(self, images, indices=None) -> Tensor:
        return self.explain(images, indices, method="attn_gradcam")
