"""BERT explanation entry points of the port: ``transformer_attribution``.

Port of ``transformer_explainability_tpu/explain/bert_generator.py`` for the
method ``transformer_attribution`` (variant ``ours``, α=1) under the
precision presets of :data:`.generator.PRECISION_PRESETS`:

    1. :func:`..models.bert.forward_collect` — the plain layers
       (``float32``), or one ``bert_layer_fwd_core`` kernel per layer with
       the slim rich anchors (``production``, ``bfloat16``);
    2. :func:`..models.bert.reverse_pass` — class gradient and LRP relevance
       together, layer by layer, plain or through ``bert_out_rev_core`` and
       ``bert_attn_rev_core``, each layer emitting its head-mean
       ``(grad ⊙ cam)⁺`` map;
    3. the ``rollout_from_grad_cam`` kernel chains the row-normalised maps
       from ``start_layer`` (default 11, as in JAX); the result is the CLS
       row over the tokens with ``row[0] = row.min()``.

The kernel path is taken, as JAX's gate takes it, for a ``bfloat16`` or
``tensorfloat32`` base with S ≤ :data:`KERNEL_MAX_SEQ`; the wrappers run
their plain versions on the CPU and the kernels on a card. The other BERT
methods, the ``lrp`` variant, α ≠ 1, ``head_mask``, activations other than
exact GELU and the precision combinations the kernels do not run raise
``NotImplementedError`` naming the ROADMAP item that ports them. Any batch
size runs as it is.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from transformer_explainability_torch.explain.generator import (
    _check_fp32_matmul, _one_hot_index, _resolve_device, check_precision)
from transformer_explainability_torch.models import bert as bert_mod
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.models.vit import megakernel_base
from transformer_explainability_torch.ops import kernels as K

Tensor = torch.Tensor

# JAX bert_generator.KERNEL_MAX_SEQ: BERT-base's position ceiling
KERNEL_MAX_SEQ = 512

METHODS = ("transformer_attribution",)
# the JAX package's other BERT methods (bert_generator.METHODS)
NOT_PORTED_METHODS = ("last_layer", "full", "last_layer_attn", "rollout",
                      "attn_gradcam")


def check_supported(cfg: BertConfig, method: str = "transformer_attribution",
                    alpha: float = 1.0, variant: str = "ours",
                    matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    head_mask: Optional[Tensor] = None) -> None:
    """Raise for every configuration this slice of the port does not run."""
    if method in NOT_PORTED_METHODS:
        raise NotImplementedError(f"BERT method {method!r} is not ported yet "
                                  "(ROADMAP A7)")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(METHODS + NOT_PORTED_METHODS)}")
    if variant != "ours" or alpha != 1.0:
        raise NotImplementedError("BERT variant 'lrp' and alpha != 1 are not "
                                  "ported yet (ROADMAP A7)")
    if head_mask is not None:
        raise NotImplementedError("BERT head_mask is not ported yet "
                                  "(ROADMAP A7)")
    if cfg.hidden_act != "gelu":
        raise NotImplementedError(f"BERT activation {cfg.hidden_act!r} is not "
                                  "ported yet (ROADMAP A7; exact GELU only)")
    check_precision(matmul_precision, relprop_precision, attn_precision,
                    mlp_precision)


def use_kernel_path(seq_len: int, matmul_precision: str) -> bool:
    """JAX ``explain_single``'s gate: the layer kernels for a ``bfloat16`` /
    ``tensorfloat32`` base at S ≤ :data:`KERNEL_MAX_SEQ`; the plain path
    for ``float32``."""
    if not megakernel_base(matmul_precision):
        return False
    if seq_len > KERNEL_MAX_SEQ:
        raise NotImplementedError(
            f"S={seq_len} > {KERNEL_MAX_SEQ} at a {matmul_precision} base "
            "takes JAX's non-kernel reduced-precision path, not ported yet "
            "(ROADMAP A7)")
    return True


@torch.no_grad()
def explain_batch(model: bert_mod.BertForSequenceClassification,
                  input_ids: Tensor, attention_mask: Tensor, indices: Tensor,
                  start_layer: int = 11,
                  method: str = "transformer_attribution",
                  ops: K.BertOps = K.BERT_KERNEL_OPS,
                  matmul_precision: str = "float32",
                  relprop_precision: Optional[str] = None,
                  attn_precision: Optional[str] = None,
                  mlp_precision: Optional[str] = None) -> Tensor:
    """Batched ``transformer_attribution`` (JAX ``bert_generator.
    explain_single`` vmapped): ``input_ids (B, S)`` int64 and
    ``attention_mask (B, S)`` 0/1 on the model's device, ``indices (B,)``
    with −1 for the argmax class. Returns the CLS row over the tokens,
    ``(B, S)``. ``ops`` selects the kernels (default) or, for a reference
    run, their plain versions."""
    cfg = model.cfg
    precision = dict(matmul_precision=matmul_precision,
                     attn_precision=attn_precision,
                     mlp_precision=mlp_precision)
    check_supported(cfg, method, relprop_precision=relprop_precision,
                    **precision)
    dtype = model.classifier.weight.dtype
    _check_fp32_matmul(input_ids.device, dtype)
    use_kernel = use_kernel_path(input_ids.shape[1], matmul_precision)
    logits, res = bert_mod.forward_collect(model, input_ids, attention_mask,
                                           ops, use_kernel, **precision)
    onehot = _one_hot_index(logits, indices, cfg.num_labels)
    _, gc = bert_mod.reverse_pass(model, res, onehot, ops, use_kernel,
                                  relprop_precision=relprop_precision,
                                  **precision)
    joint = ops.rollout_from_grad_cam(gc, start_layer, True)
    row = joint[:, 0].clone()
    row[:, 0] = row.min(dim=-1).values           # rollout[:, 0, 0] = min
    return row


def make_explain_fn(cfg: BertConfig, device,
                    method: str = "transformer_attribution",
                    start_layer: int = 11, alpha: float = 1.0,
                    variant: str = "ours", matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None) -> Callable:
    """Build ``fn(model, input_ids, attention_mask, indices) -> (B, S)``
    (JAX ``bert_generator.make_explain_fn``). Inputs may be numpy arrays or
    tensors; they are moved to ``device``."""
    precision = dict(matmul_precision=matmul_precision,
                     relprop_precision=relprop_precision,
                     attn_precision=attn_precision,
                     mlp_precision=mlp_precision)
    check_supported(cfg, method, alpha, variant, **precision)
    device = _resolve_device(device)

    def fn(model: bert_mod.BertForSequenceClassification, input_ids,
           attention_mask, indices) -> Tensor:
        if model.cfg != cfg:
            raise ValueError("model config differs from the explain fn's")
        ids = torch.as_tensor(input_ids, device=device).to(torch.int64)
        if ids.ndim != 2 or ids.shape[1] > cfg.max_position_embeddings:
            raise ValueError(f"input_ids must be (B, S) with S <= "
                             f"{cfg.max_position_embeddings}, got "
                             f"{tuple(ids.shape)}")
        mask = torch.as_tensor(attention_mask, device=device).reshape(
            ids.shape)
        idx = torch.as_tensor(indices, device=device).to(torch.int64)
        return explain_batch(model, ids, mask, idx.reshape(ids.shape[0]),
                             start_layer, method, **precision)

    return fn


class BertExplainer:
    """Convenience wrapper around a model built from ``params`` (an
    HF-named state dict, e.g. from :func:`..models.bert.init_params` or
    :func:`..params.convert.bert_params_from_jax`) on ``device``, in the
    params' dtype (JAX ``bert_generator.BertExplainer``). The precision
    arguments are those of :data:`.generator.PRECISION_PRESETS`, e.g.
    ``BertExplainer(params, cfg, "cuda", **precision_kwargs("production"))``.
    """

    def __init__(self, params: Mapping[str, Tensor], cfg: BertConfig, device,
                 variant: str = "ours", matmul_precision: str = "float32",
                 relprop_precision=None, attn_precision=None,
                 mlp_precision=None):
        self.precision = dict(matmul_precision=matmul_precision,
                              relprop_precision=relprop_precision,
                              attn_precision=attn_precision,
                              mlp_precision=mlp_precision)
        check_supported(cfg, variant=variant, **self.precision)
        self.device = _resolve_device(device)
        self.cfg = cfg
        dtype = params["classifier.weight"].dtype
        self.model = bert_mod.BertForSequenceClassification(
            cfg, device=self.device, dtype=dtype)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False)

    def explain(self, input_ids, attention_mask, indices=None,
                method: str = "transformer_attribution",
                start_layer: int = 11, alpha: float = 1.0) -> Tensor:
        """``input_ids``/``attention_mask`` ``(B, S)`` or one ``(S,)``;
        ``indices`` per sample, −1 (or None for all) meaning the argmax
        class. Returns ``(B, S)`` on the explainer's device."""
        ids = torch.as_tensor(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        if indices is None:
            indices = torch.full((ids.shape[0],), -1, dtype=torch.int64)
        fn = make_explain_fn(self.cfg, self.device, method, start_layer,
                             alpha, **self.precision)
        return fn(self.model, ids, attention_mask, indices)

    # reference Generator method names
    def generate_LRP(self, input_ids, attention_mask, index=None,
                     start_layer: int = 11) -> Tensor:
        return self.explain(input_ids, attention_mask, index,
                            "transformer_attribution", start_layer)

    def generate_LRP_last_layer(self, input_ids, attention_mask, index=None):
        return self.explain(input_ids, attention_mask, index, "last_layer")

    def generate_full_lrp(self, input_ids, attention_mask, index=None):
        return self.explain(input_ids, attention_mask, index, "full")

    def generate_attn_last_layer(self, input_ids, attention_mask, index=None):
        return self.explain(input_ids, attention_mask, index,
                            "last_layer_attn")

    def generate_rollout(self, input_ids, attention_mask, start_layer=0,
                         index=None):
        return self.explain(input_ids, attention_mask, index, "rollout",
                            start_layer)

    def generate_attn_gradcam(self, input_ids, attention_mask, index=None):
        return self.explain(input_ids, attention_mask, index, "attn_gradcam")


__all__ = ["KERNEL_MAX_SEQ", "METHODS", "NOT_PORTED_METHODS",
           "check_supported", "use_kernel_path", "explain_batch",
           "make_explain_fn", "BertExplainer"]
