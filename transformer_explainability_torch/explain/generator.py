"""Explanation entry points of the port: ``transformer_attribution`` on ViT.

Port of ``transformer_explainability_tpu/explain/generator.py`` for the
method ``transformer_attribution`` (and its alias ``grad``) under the
precision presets ``float32`` (exact FP32), ``production`` and ``bfloat16``
(:data:`PRECISION_PRESETS`, :func:`precision_kwargs`):

    1. :func:`..models.vit.forward_collect` — forward with the attention
       core in the ``attn_fwd_core`` kernel (float32), or whole blocks in the
       ``block_fwd_core`` megakernel with the rich anchors (the presets);
    2. :func:`..models.vit.reverse_pass` — class gradient and LRP relevance
       together, block by block, in ``attn_rev_core`` (float32) or the
       ``block_rev_core`` megakernel, each block emitting its head-mean
       ``(grad ⊙ cam)⁺`` map;
    3. the ``rollout_from_grad_cam`` kernel chains the maps; the heatmap is
       the CLS row over the patch tokens.

In every preset the embedding, the final norm and the head are exact
products in the parameters' dtype (float32 on a card needs TF32 off).

The JAX package jit-compiles one program per configuration and pads
batches to power-of-two buckets; here PyTorch runs eagerly, the batch is
the leading dimension, and any batch size runs as it is.

Other methods, the ``lrp`` variant, α ≠ 1, the precision combinations the
kernels do not run and ``with_diagnostics`` raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from transformer_explainability_torch.models import vit as vit_mod
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as prec

Tensor = torch.Tensor

METHODS = ("transformer_attribution", "grad")
# the JAX package's other ViT methods (generator.METHODS)
NOT_PORTED_METHODS = ("rollout", "full", "last_layer", "last_layer_attn",
                      "second_layer", "attn_gradcam", "rollout_attn")

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


def check_supported(method: str = "transformer_attribution",
                    alpha: float = 1.0, variant: str = "ours",
                    matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    with_diagnostics: bool = False) -> None:
    """Raise for every configuration this slice of the port does not run."""
    if method in NOT_PORTED_METHODS:
        raise NotImplementedError(f"method {method!r} is not ported yet "
                                  "(ROADMAP A4)")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(METHODS + NOT_PORTED_METHODS)}")
    if variant != "ours":
        raise NotImplementedError(f"variant {variant!r} is not ported yet "
                                  "(ROADMAP A3, the non-kernel reverse)")
    if alpha != 1.0:
        raise NotImplementedError("alpha != 1 is not ported yet (ROADMAP A3, "
                                  "the non-kernel reverse)")
    check_precision(matmul_precision, relprop_precision, attn_precision,
                    mlp_precision)
    if with_diagnostics:
        raise NotImplementedError("with_diagnostics is not ported yet "
                                  "(ROADMAP A4)")


def check_precision(matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None) -> None:
    """The JAX gates of the kernel path (generator.py, vit.py): float32
    runs the B4/B5 path with no islands; bfloat16 / tensorfloat32 run the
    block megakernels when no weight-consuming island exceeds the base, the
    rule products are bfloat16 and the attention's are float32 or
    bfloat16."""
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
                  mlp_precision: Optional[str] = None) -> Tensor:
    """Batched ``transformer_attribution`` (JAX ``generator.explain_single``
    vmapped): ``images (B, C, H, W)`` in the model's dtype and device,
    ``indices (B,)`` int64 with −1 for the argmax class. Returns the CLS-row
    relevance over the patches, ``(B, num_patches)``. ``ops`` selects the
    kernels (default) or, for a reference run, their plain versions; the
    precision arguments are those of :data:`PRECISION_PRESETS`."""
    precision = dict(matmul_precision=matmul_precision,
                     attn_precision=attn_precision,
                     mlp_precision=mlp_precision)
    check_supported(method, relprop_precision=relprop_precision, **precision)
    cfg = model.cfg
    _check_fp32_matmul(images.device, images.dtype)
    logits, res = vit_mod.forward_collect(model, images, ops, **precision)
    onehot = _one_hot_index(logits, indices, cfg.num_classes)
    _, gc = vit_mod.reverse_pass(model, res, onehot, ops=ops,
                                 relprop_precision=relprop_precision,
                                 **precision)
    joint = ops.rollout_from_grad_cam(gc, start_layer)
    return joint[:, 0, cfg.num_prefix_tokens:]


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available")
    return device


def make_explain_fn(cfg: ViTConfig, device,
                    method: str = "transformer_attribution",
                    start_layer: int = 0, alpha: float = 1.0,
                    variant: str = "ours", matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    with_diagnostics: bool = False,
                    preprocess: Optional[str] = None) -> Callable:
    """Build ``fn(model, images, indices) -> heatmaps (B, num_patches)``
    (JAX ``generator.make_explain_fn``). ``images`` are ``(B, C, H, W)``, or
    raw ``(B, H, W, C)`` uint8 frames with ``preprocess="uint8"``;
    ``indices (B,)``, −1 for the argmax class. Inputs may be numpy arrays or
    tensors; they are moved to ``device`` and the model's dtype."""
    check_supported(method, alpha, variant, matmul_precision,
                    relprop_precision, attn_precision, mlp_precision,
                    with_diagnostics)
    if preprocess not in (None, "uint8"):
        raise ValueError(f"unknown preprocess {preprocess!r} "
                         "(None or 'uint8')")
    device = _resolve_device(device)
    precision = dict(matmul_precision=matmul_precision,
                     relprop_precision=relprop_precision,
                     attn_precision=attn_precision,
                     mlp_precision=mlp_precision)

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
                             start_layer, method, **precision)

    return fn


class Explainer:
    """Convenience wrapper around a model built from ``params`` (a timm-named
    state dict, e.g. from :func:`..models.vit.init_params` or
    :func:`..params.convert.vit_params_from_jax`) on ``device``, in the
    params' dtype (JAX ``generator.Explainer``). The precision arguments
    are those of :data:`PRECISION_PRESETS`, e.g.
    ``Explainer(params, cfg, "cuda", **precision_kwargs("production"))``."""

    def __init__(self, params: Mapping[str, Tensor], cfg: ViTConfig, device,
                 variant: str = "ours", matmul_precision: str = "float32",
                 relprop_precision=None, attn_precision=None,
                 mlp_precision=None):
        self.precision = dict(matmul_precision=matmul_precision,
                              relprop_precision=relprop_precision,
                              attn_precision=attn_precision,
                              mlp_precision=mlp_precision)
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
                start_layer: int = 0, alpha: float = 1.0) -> Tensor:
        """``images (B, C, H, W)`` or one ``(C, H, W)``; ``indices`` per
        sample, −1 (or None for all) meaning the argmax class. Returns
        ``(B, num_patches)`` on the explainer's device."""
        images = torch.as_tensor(images)
        if images.ndim == 3:
            images = images[None]
        B = images.shape[0]
        if indices is None:
            indices = torch.full((B,), -1, dtype=torch.int64)
        fn = make_explain_fn(self.cfg, self.device, method, start_layer,
                             alpha, **self.precision)
        return fn(self.model, images, indices)

    # the reference Baselines API surface
    def generate_rollout(self, images, start_layer: int = 0):
        raise NotImplementedError("rollout_attn is not ported yet "
                                  "(ROADMAP A4)")

    def generate_cam_attn(self, images, indices=None):
        raise NotImplementedError("attn_gradcam is not ported yet "
                                  "(ROADMAP A4)")
