"""BERT explanation entry points of the port: the six methods of the JAX
package's ``explain/bert_generator.py`` (the reference ``Generator``'s).

Every method returns the CLS row over the tokens, ``(B, S)``, with the
reference's special-token handling (:func:`explain_batch`). The JAX gate
picks the path:

  * ``transformer_attribution`` with variant ``ours``, α=1 and exact GELU
    at a ``bfloat16`` or ``tensorfloat32`` base with S ≤
    :data:`KERNEL_MAX_SEQ` and no rule or MLP island above the base (the
    ``production`` and ``bfloat16`` presets) takes the layer kernels: :func:`..models.bert.forward_collect` runs one
    ``bert_layer_fwd_core`` per layer with the slim rich anchors, and
    :func:`..models.bert.reverse_pass` ``bert_out_rev_core`` and
    ``bert_attn_rev_core``, each layer emitting its head-mean ``(grad ⊙
    cam)⁺`` map;
  * everything else, at any base and with any islands, takes the plain
    layers (every method, both rule variants, any α), keeping what the
    method reads: the relevance chain, the class gradient, the per-layer
    probabilities; their products run in JAX's modes
    (:mod:`..models.bert`).

``transformer_attribution`` chains its maps in the ``rollout_from_grad_cam``
kernel, as JAX does in its Pallas chain; ``rollout`` too at the ``float32``
base (from the per-head probabilities, through its head-mean pass), while
at a reduced base it is JAX's XLA chain at the base's mode
(:func:`..ops.relprop.compute_rollout`). The wrappers run their plain
versions on the CPU and the kernels on a card. The layer kernels have no
bf16×3 attention or rule products yet: a ``tensorfloat32`` attention or
rule mode on them (raw ``tensorfloat32``) raises ``NotImplementedError``
naming "ROADMAP B, raw tensorfloat32 (BERT)". Any batch size runs as it
is.

The guarded mode's strict form for BERT (JAX's
``make_guarded_bert_explain_fn``): the ``production`` program checked per
sample against the exact-FP32 one on the same device, flagged samples re-run
on the host CPU (:func:`make_cpu_exact_bert_fn`).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from transformer_explainability_torch.explain.generator import (
    PRECISION_PRESETS, STRICT_AGREEMENT, _check_fp32_matmul, _check_names,
    _guard_flags, _one_hot_index, _resolve_device, _to_host, check_precision,
    cpu_exact_cache)
from transformer_explainability_torch.models import bert as bert_mod
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.models.vit import megakernel_base
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as prec
from transformer_explainability_torch.ops import relprop as rp

Tensor = torch.Tensor

# JAX bert_generator.KERNEL_MAX_SEQ: BERT-base's position ceiling
KERNEL_MAX_SEQ = 512

# method -> needs (attention gradients, relevance chain) (JAX
# bert_generator.METHODS; the reference Generator's method beside each)
METHODS = {
    "transformer_attribution": (True, True),    # generate_LRP
    "last_layer": (False, True),                # generate_LRP_last_layer
    "full": (False, True),                      # generate_full_lrp
    "last_layer_attn": (False, False),          # generate_attn_last_layer
    "rollout": (False, False),                  # generate_rollout
    "attn_gradcam": (True, False),              # generate_attn_gradcam
}
# the methods that read the per-layer attention probabilities
PROBS_METHODS = ("last_layer_attn", "rollout", "attn_gradcam")
ACTIVATIONS = ("gelu", "relu", "tanh")


def check_supported(cfg: BertConfig, method: str = "transformer_attribution",
                    alpha: float = 1.0, variant: str = "ours",
                    matmul_precision: str = "float32",
                    relprop_precision: Optional[str] = None,
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    seq_len: Optional[int] = None) -> None:
    """Raise for every configuration the port does not run; without
    ``seq_len`` an eligible call is checked as the layer kernels would
    take it (S ≤ :data:`KERNEL_MAX_SEQ`)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(METHODS)}")
    if variant not in ("ours", "lrp"):
        raise ValueError(f"unknown variant {variant!r} ('ours' or 'lrp')")
    if cfg.hidden_act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.hidden_act!r}; "
                         f"available: {list(ACTIVATIONS)}")
    _check_names(matmul_precision, relprop_precision, attn_precision,
                 mlp_precision)
    if (eligible(cfg, method, alpha, variant, matmul_precision,
                 relprop_precision, mlp_precision)
            and use_kernel_path(seq_len or KERNEL_MAX_SEQ, matmul_precision)):
        # the layer kernels' modes; the plain path takes any
        check_precision(matmul_precision, relprop_precision, attn_precision,
                        mlp_precision, family="bert")


def eligible(cfg: BertConfig, method: str, alpha: float, variant: str,
             matmul_precision: str = "float32",
             relprop_precision: Optional[str] = None,
             mlp_precision: Optional[str] = None) -> bool:
    """JAX ``explain_single``'s eligibility for the layer kernels: the
    fused method with variant ``ours`` at α=1, exact GELU and no rule or
    MLP island above the base (the kernels' prepared weights cannot serve
    one)."""
    return (method == "transformer_attribution"
            and cfg.hidden_act == "gelu" and variant == "ours"
            and alpha == 1.0
            and not prec.islands_exceed_base(
                matmul_precision, relprop_precision, mlp_precision))


def use_kernel_path(seq_len: int, matmul_precision: str) -> bool:
    """JAX ``explain_single``'s gate for an eligible call: the layer
    kernels for a ``bfloat16`` / ``tensorfloat32`` base at S ≤
    :data:`KERNEL_MAX_SEQ`; the plain path for ``float32`` and above
    :data:`KERNEL_MAX_SEQ`, in the base's modes."""
    return megakernel_base(matmul_precision) and seq_len <= KERNEL_MAX_SEQ


@torch.no_grad()
def explain_batch(model: bert_mod.BertForSequenceClassification,
                  input_ids: Tensor, attention_mask: Tensor, indices: Tensor,
                  start_layer: int = 11,
                  method: str = "transformer_attribution",
                  ops: K.BertOps = K.BERT_KERNEL_OPS,
                  matmul_precision: str = "float32",
                  relprop_precision: Optional[str] = None,
                  attn_precision: Optional[str] = None,
                  mlp_precision: Optional[str] = None, alpha: float = 1.0,
                  variant: str = "ours") -> Tensor:
    """Batched explanation (JAX ``bert_generator.explain_single`` vmapped):
    ``input_ids (B, S)`` int64 and ``attention_mask (B, S)`` 0/1 on the
    model's device, ``indices (B,)`` with −1 for the argmax class. Returns
    the CLS row over the tokens, ``(B, S)``, per method:

      * ``transformer_attribution``: the rollout from ``start_layer`` of the
        row-normalised ``(grad ⊙ cam)⁺`` head means, ``row[0] = row.min()``;
      * ``last_layer``: the last layer's relevance map, clamped at 0 and
        averaged over the heads;
      * ``full``: the relevance at the layer-0 input, summed over features;
      * ``last_layer_attn``: the last layer's probabilities averaged over
        the heads;
      * ``rollout``: the rollout from ``start_layer`` of the row-normalised
        head-mean probabilities;
      * ``attn_gradcam``: the last layer's probabilities times each head's
        mean gradient, averaged over the heads, clamped at 0 and min-max
        normalised over the whole map (0/0, NaN, for a map with no positive
        entry, as in JAX);

    each but the first with ``row[0] = 0``. ``ops`` selects the kernels
    (default) or, for a reference run, their plain versions."""
    cfg = model.cfg
    precision = dict(matmul_precision=matmul_precision,
                     attn_precision=attn_precision,
                     mlp_precision=mlp_precision)
    check_supported(cfg, method, alpha, variant,
                    relprop_precision=relprop_precision, **precision,
                    seq_len=input_ids.shape[1])
    dtype = model.classifier.weight.dtype
    _check_fp32_matmul(input_ids.device, dtype)
    use_kernel = (eligible(cfg, method, alpha, variant, matmul_precision,
                           relprop_precision, mlp_precision)
                  and use_kernel_path(input_ids.shape[1], matmul_precision))
    needs_grads, needs_relprop = METHODS[method]
    fused = method == "transformer_attribution"
    logits, res = bert_mod.forward_collect(
        model, input_ids, attention_mask, ops, use_kernel, **precision,
        keep_probs=method in PROBS_METHODS)
    R_tokens = cams = grads = None
    if needs_grads or needs_relprop:
        onehot = _one_hot_index(logits, indices, cfg.num_labels)
        R_tokens, cams, grads = bert_mod.reverse_pass(
            model, res, onehot, ops, use_kernel,
            relprop_precision=relprop_precision, alpha=alpha,
            variant=variant, need_grads=needs_grads,
            need_relprop=needs_relprop, fuse_grad_cam=fused, **precision)
    if fused:
        joint = ops.rollout_from_grad_cam(cams, start_layer, True, rows=1)
        row = joint[:, 0].clone()
        row[:, 0] = row.min(dim=-1).values       # rollout[:, 0, 0] = min
        return row
    if method == "rollout" and megakernel_base(matmul_precision):
        # JAX chains the head means in XLA at the base's mode here
        row = rp.compute_rollout(res.probs.mean(dim=2), start_layer, True,
                                 prec.mxu_name(matmul_precision))[:, 0]
    elif method == "rollout":
        row = ops.rollout_from_grad_cam(res.probs, start_layer, True,
                                        rows=1)[:, 0]
    elif method == "last_layer":
        row = cams[:, -1, :, 0].clamp(min=0).mean(dim=1)
    elif method == "full":
        row = R_tokens.sum(dim=-1)
    elif method == "last_layer_attn":
        row = res.probs[:, -1, :, 0].mean(dim=1)
    else:                                        # attn_gradcam
        grad = grads[:, -1].mean(dim=(2, 3), keepdim=True)
        cam = (res.probs[:, -1] * grad).mean(dim=1).clamp(min=0)
        lo = cam.amin(dim=(1, 2), keepdim=True)
        row = ((cam - lo) / (cam.amax(dim=(1, 2), keepdim=True) - lo))[:, 0]
    row = row.clone()
    row[:, 0] = 0.0
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
    # the calls' lengths are theirs (explain_batch checks each); here the
    # longest the config takes
    check_supported(cfg, method, alpha, variant, **precision,
                    seq_len=cfg.max_position_embeddings)
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
                             start_layer, method, alpha=alpha,
                             variant=variant, **precision)

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
        self.variant = variant
        self.precision = dict(matmul_precision=matmul_precision,
                              relprop_precision=relprop_precision,
                              attn_precision=attn_precision,
                              mlp_precision=mlp_precision)
        # the method and the length are the call's: each explain checks
        if variant not in ("ours", "lrp"):
            raise ValueError(f"unknown variant {variant!r} ('ours' or "
                             "'lrp')")
        _check_names(*self.precision.values())
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
                             alpha, self.variant, **self.precision)
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


def make_cpu_exact_bert_fn(cfg: BertConfig, start_layer: int = 11,
                           matmul_precision: str = "float32",
                           variant: str = "ours") -> Callable:
    """One-sample exact BERT ``transformer_attribution`` on the host CPU
    (JAX ``bert_generator.make_cpu_exact_bert_fn``): ``fn(model, input_ids,
    attention_mask, index) -> (S,)`` (numpy), on a CPU copy of ``model`` in
    its dtype, cached as :func:`..generator.make_cpu_exact_fn` caches its
    copy (``fn.copy.calls`` counts the calls)."""
    cpu = torch.device("cpu")
    explain = make_explain_fn(cfg, cpu, start_layer=start_layer,
                              variant=variant,
                              matmul_precision=matmul_precision)
    copy = cpu_exact_cache(lambda dtype: (
        bert_mod.BertForSequenceClassification(cfg, device=cpu, dtype=dtype)))

    def fn(model: bert_mod.BertForSequenceClassification, input_ids,
           attention_mask, index) -> np.ndarray:
        cpu_model = copy(model)
        host = [torch.as_tensor(a).detach().to(cpu)[None]
                for a in (input_ids, attention_mask)]
        idx = torch.as_tensor(index).detach().to(cpu).reshape(1)
        return explain(cpu_model, *host, idx)[0].numpy()

    fn.copy = copy
    return fn


def make_guarded_bert_explain_fn(cfg: BertConfig, device,
                                 start_layer: int = 11,
                                 agreement: Optional[float] = None,
                                 fallback_precision: str = "float32",
                                 fallback: str = "sync",
                                 return_info: bool = False,
                                 variant: str = "ours",
                                 **precision_overrides) -> Callable:
    """The guarded ``production`` mode for BERT, strict only (JAX
    ``bert_generator.make_guarded_bert_explain_fn``; the envelope's
    diagnostics are the ViT reverse's): the ``production`` program (with
    ``precision_overrides``) and the exact-FP32 one on ``device``; a sample
    whose two rows correlate below ``agreement`` (default
    :data:`..generator.STRICT_AGREEMENT`) is flagged and, with
    ``fallback="sync"``, re-run by :func:`make_cpu_exact_bert_fn` in
    ``fallback_precision`` (``fn.cpu_exact``). Returns ``fn(model,
    input_ids, attention_mask, indices, n_valid=None) -> (B, S)`` (numpy),
    with ``return_info`` ``(rows, {"flagged", "score"})``, as the ViT
    guarded function does."""
    if fallback not in ("sync", "defer"):
        raise ValueError(f"unknown fallback policy {fallback!r}")
    agreement = STRICT_AGREEMENT if agreement is None else agreement
    kwargs = dict(PRECISION_PRESETS["production"], **precision_overrides)
    device = _resolve_device(device)
    fast = make_explain_fn(cfg, device, start_layer=start_layer,
                           variant=variant, **kwargs)
    verify = make_explain_fn(cfg, device, start_layer=start_layer,
                             variant=variant)
    cpu_exact = make_cpu_exact_bert_fn(cfg, start_layer, fallback_precision,
                                       variant)

    def guarded(model: bert_mod.BertForSequenceClassification, input_ids,
                attention_mask, indices, n_valid: Optional[int] = None):
        heat_d, ver_d = (fast(model, input_ids, attention_mask, indices),
                         verify(model, input_ids, attention_mask, indices))
        heat = _to_host(heat_d)
        flagged, score = _guard_flags("strict", heat, _to_host(ver_d),
                                      agreement, n_valid=n_valid)
        if fallback == "sync":
            for i in np.flatnonzero(flagged):
                heat[i] = cpu_exact(model, input_ids[i], attention_mask[i],
                                    indices[i])
        if return_info:
            return heat, {"flagged": flagged, "score": score}
        return heat

    guarded.cpu_exact = cpu_exact
    return guarded


__all__ = ["KERNEL_MAX_SEQ", "METHODS", "PROBS_METHODS", "ACTIVATIONS",
           "check_supported", "eligible", "use_kernel_path", "explain_batch",
           "make_explain_fn", "BertExplainer", "make_cpu_exact_bert_fn",
           "make_guarded_bert_explain_fn"]
