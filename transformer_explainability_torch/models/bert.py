"""Explainable BERT in PyTorch (port of
``transformer_explainability_tpu/models/bert.py``).

  * The plain path (``matmul_precision="float32"``, and at every base each
    method but ``transformer_attribution`` with variant ``ours``, α=1 and
    GELU, that one too at S > 512 or with an island above the base):
    :func:`forward_collect` is the
    JAX ``lax.scan`` forward (:func:`layer_acts`, two anchors per layer,
    the per-layer attention probabilities kept when a method reads them)
    and :func:`reverse_pass` the JAX reverse scan (:func:`layer_backward`
    and :func:`layer_relprop`, recomputed from the anchors): the class
    gradient, the LRP relevance or both, in either rule variant and any α,
    per-head or folded into the ``(grad ⊙ cam)⁺`` head mean. Activations
    ``gelu`` (exact), ``relu`` and ``tanh``, token types and an ``(L, h)``
    head mask are taken as JAX takes them. All plain PyTorch, each product
    in the mode of a :class:`..ops.precision.Policy` as JAX's lowered
    program runs it: the attention products (scores, P·V, their backward)
    in the attention island's mode, the rules inside the layers in the
    rule island's, every other product (the layers' Linear products and
    their gradients, the pooler and the classifier with their seeds) at
    the base; JAX's plain layers take no MLP precision.
  * The kernel path (``matmul_precision`` ``"bfloat16"`` or
    ``"tensorfloat32"``, the ``production`` and ``bfloat16`` presets;
    ``transformer_attribution``, variant ``ours``, α=1, exact GELU, no head
    mask): one :func:`..ops.kernels.bert_layer_fwd_core` per layer (saving
    the slim rich anchors qkv_pre, ctx, dense_nb) and, per layer from the
    last down, :func:`..ops.kernels.bert_out_rev_core` then
    :func:`..ops.kernels.bert_attn_rev_core`, each layer yielding its
    head-mean ``(grad ⊙ cam)⁺`` map. The layer weights are prepared once
    per model and mode (:meth:`BertForSequenceClassification.
    layer_params`).

The embeddings have no product; on the kernel path the pooler and the
classifier stay exact products in the parameters' dtype (float32 on a card
needs TF32 off). :func:`train_forward`
is the training forward (JAX ``bert.train_forward``): plain PyTorch under
autograd, with dropout at the Hugging Face sites.

The modules hold parameters under the Hugging Face names that the JAX
package's ``bert_state_dict_from_params`` exports
(``bert.encoder.layer.{i}.attention.self.query``, ..., ``classifier``), so
the state dicts of ``params.convert.bert_params_from_jax`` load as they are.
Inputs are ``(B, S)`` token ids, ``(B, S)`` 0/1 attention masks and
optional ``(B, S)`` token types (0 by default); positions are
``arange(S)``, the JAX default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as prec
from transformer_explainability_torch.ops import relprop as rp
from transformer_explainability_torch.ops.bert_math import BertLayerParams

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    # transformers 3.5.1 extends 0/1 masks as (1 - mask) * -10000 (JAX
    # BertConfig.mask_value)
    mask_value: float = -10000.0
    hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_BASE_UNCASED = BertConfig()


# ---------------------------------------------------------------------------
# Modules (parameter containers under the Hugging Face names)
# ---------------------------------------------------------------------------

class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        D = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, D, **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                D, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, D,
                                                  **kw)
        self.LayerNorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps, **kw)
        # persistent, as the reference's BertEmbeddings registers it
        self.register_buffer("position_ids", torch.arange(
            cfg.max_position_embeddings, device=kw.get("device"))[None])


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        D = cfg.hidden_size
        self.query = nn.Linear(D, D, **kw)
        self.key = nn.Linear(D, D, **kw)
        self.value = nn.Linear(D, D, **kw)


class BertDenseNorm(nn.Module):
    """``BertSelfOutput`` / ``BertOutput``: a dense and a LayerNorm."""

    def __init__(self, cfg: BertConfig, d_in: int, **kw):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size, **kw)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                      **kw)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.self = BertSelfAttention(cfg, **kw)
        self.output = BertDenseNorm(cfg, cfg.hidden_size, **kw)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.attention = BertAttention(cfg, **kw)
        self.intermediate = BertIntermediate(cfg, **kw)
        self.output = BertDenseNorm(cfg, cfg.intermediate_size, **kw)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, **kw)
                                   for _ in range(cfg.num_layers))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, **kw)
        self.encoder = BertEncoder(cfg, **kw)
        self.pooler = BertPooler(cfg, **kw)


class BertForSequenceClassification(nn.Module):
    """BERT parameters in the HF classification layout (``bert.*`` and
    ``classifier``); ``forward`` gives the logits."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.bert = BertModel(cfg, **kw)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels, **kw)

    @torch.no_grad()
    def forward(self, input_ids: Tensor, attention_mask: Tensor,
                token_type_ids: Optional[Tensor] = None) -> Tensor:
        return forward_collect(self, input_ids, attention_mask,
                               token_type_ids=token_type_ids)[0]

    def layer_params(self, i: int, mode: str) -> BertLayerParams:
        """Layer ``i``'s parameters for the kernels, its four weights
        prepared for ``mode`` (JAX ``prepare_bert_weights``, with query, key
        and value stacked into one ``(3D, D)`` weight). Made once per model
        and mode and kept; made again only when a weight or bias tensor is
        replaced or changed in place."""
        lay = self.bert.encoder.layer[i]
        sa = lay.attention.self
        lins = (sa.query, sa.key, sa.value, lay.attention.output.dense,
                lay.intermediate.dense, lay.output.dense)
        key = tuple((t.data_ptr(), t._version) for lin in lins
                    for t in (lin.weight, lin.bias))
        cache = self.__dict__.setdefault("_prepared", {})
        if cache.get((i, mode), (None,))[0] != key:
            w_qkv = torch.cat([sa.query.weight, sa.key.weight,
                               sa.value.weight])
            b_qkv = torch.cat([sa.query.bias, sa.key.bias, sa.value.bias])
            ws = tuple(prec.prepare_weight(w, mode) for w in (
                w_qkv, lins[3].weight, lins[4].weight, lins[5].weight))
            cache[(i, mode)] = (key, b_qkv, ws)
        _, b_qkv, ws = cache[(i, mode)]
        a_ln, o_ln = lay.attention.output.LayerNorm, lay.output.LayerNorm
        return BertLayerParams(a_ln.weight, a_ln.bias, o_ln.weight, o_ln.bias,
                               b_qkv, lins[3].bias, lins[4].bias,
                               lins[5].bias, *ws)


def init_params(cfg: BertConfig, *, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Tensor]:
    """Random weights in the HF classification layout (JAX
    ``bert.init_params``): normal(0, 0.02) embeddings and Linear weights,
    zero biases, unit/zero LayerNorms. The numbers are drawn on
    ``generator``'s device and then moved to ``device`` (pass a CPU
    generator and a seed is one model on every device); the same seed gives
    other numbers than JAX's ``PRNGKey``."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    kw = dict(device=generator.device, dtype=dtype)

    def nrm(*shape):
        return 0.02 * torch.randn(*shape, generator=generator, **kw)

    def zeros(n):
        return torch.zeros(n, **kw)

    e = "bert.embeddings."
    sd = {
        e + "position_ids": torch.arange(cfg.max_position_embeddings,
                                         device=generator.device)[None],
        e + "word_embeddings.weight": nrm(cfg.vocab_size, D),
        e + "position_embeddings.weight": nrm(cfg.max_position_embeddings, D),
        e + "token_type_embeddings.weight": nrm(cfg.type_vocab_size, D),
        e + "LayerNorm.weight": torch.ones(D, **kw),
        e + "LayerNorm.bias": zeros(D),
    }
    linears = (("attention.self.query", D, D), ("attention.self.key", D, D),
               ("attention.self.value", D, D),
               ("attention.output.dense", D, D),
               ("intermediate.dense", D, I), ("output.dense", I, D))
    for i in range(cfg.num_layers):
        p = f"bert.encoder.layer.{i}."
        for name, d_in, d_out in linears:
            sd[p + name + ".weight"] = nrm(d_out, d_in)
            sd[p + name + ".bias"] = zeros(d_out)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = torch.ones(D, **kw)
            sd[p + ln + ".bias"] = zeros(D)
    sd["bert.pooler.dense.weight"] = nrm(D, D)
    sd["bert.pooler.dense.bias"] = zeros(D)
    sd["classifier.weight"] = nrm(cfg.num_labels, D)
    sd["classifier.bias"] = zeros(cfg.num_labels)
    return {k: v.to(device) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layernorm(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """JAX ``vit._layernorm``: (x − μ) · rsqrt(var + eps) · γ + β."""
    return bm.ln_fwd(x, ln.weight, ln.bias, ln.eps)[0]


def _lin(x: Tensor, lin: nn.Linear, mode: str = "float32") -> Tensor:
    """``x @ kernel + bias`` as the JAX package writes it, the product in
    ``mode``."""
    return prec.product(x, lin.weight.t(), mode) + lin.bias


def _act(x: Tensor, name: str) -> Tensor:
    """The MLP activation (JAX ``bert._act``)."""
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="none")
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {name!r}")


def _act_grad(pre: Tensor, name: str) -> Tensor:
    """Its derivative at the pre-activation (JAX ``bert._act_grad``)."""
    if name == "gelu":
        return bm.gelu_grad(pre)
    if name == "relu":
        return (pre > 0).to(pre.dtype)
    if name == "tanh":
        t = torch.tanh(pre)
        return 1.0 - t * t
    raise ValueError(f"unknown activation {name!r}")


def _heads(x: Tensor, cfg: BertConfig) -> Tensor:
    """(B, S, D) -> (B, h, S, hd) (JAX ``bert._heads``)."""
    return bm.to_heads(x, cfg.num_heads, cfg.head_dim)


class LayerActs(NamedTuple):
    """JAX ``bert.LayerActs``, batched."""
    q: Tensor            # (B, h, S, hd)
    k: Tensor
    v: Tensor
    scaled: Tensor       # scaled scores before the mask add (B, h, S, S)
    probs: Tensor        # (B, h, S, S)
    ctx: Tensor          # merged context (B, S, D)
    dense_out: Tensor    # attention output dense (B, S, D)
    att_mid: Tensor      # dense_out + x_in, pre-LN
    inter_pre: Tensor    # (B, S, I)
    inter_g: Tensor      # (B, S, I)
    dense2: Tensor       # (B, S, D)
    # the probabilities the AV product consumed, after the head mask (None
    # without one: they are ``probs``)
    probs_m: Optional[Tensor] = None


def layer_acts(x_in: Tensor, att_ln: Optional[Tensor], layer: BertLayer,
               ext_mask: Tensor, cfg: BertConfig,
               head_mask: Optional[Tensor] = None,
               pol: prec.Policy = prec.EXACT
               ) -> Tuple[Tensor, Tensor, LayerActs]:
    """One encoder layer from its input (JAX ``bert._layer_acts``); pass
    the saved ``att_ln`` to recompute. ``head_mask`` ``(h,)`` multiplies
    the post-softmax probabilities per head. The scores and P·V run in
    ``pol.attn``, the Linear products at ``pol.base``. Returns ``(att_ln,
    out, acts)``."""
    sa = layer.attention.self
    base = pol.base
    q = _heads(_lin(x_in, sa.query, base), cfg)
    k = _heads(_lin(x_in, sa.key, base), cfg)
    v = _heads(_lin(x_in, sa.value, base), cfg)
    raw = prec.product(q, k.transpose(-1, -2), pol.attn)
    scaled = raw / math.sqrt(cfg.head_dim)
    probs = torch.softmax(scaled + ext_mask[:, None, None, :], dim=-1)
    probs_m = None
    if head_mask is not None:
        probs_m = probs * head_mask[:, None, None]
    ctx = bm.merge_heads(prec.product(
        probs if probs_m is None else probs_m, v, pol.attn))
    dense_out = _lin(ctx, layer.attention.output.dense, base)
    att_mid = dense_out + x_in
    if att_ln is None:
        att_ln = _layernorm(att_mid, layer.attention.output.LayerNorm)
    inter_pre = _lin(att_ln, layer.intermediate.dense, base)
    inter_g = _act(inter_pre, cfg.hidden_act)
    dense2 = _lin(inter_g, layer.output.dense, base)
    out = _layernorm(dense2 + att_ln, layer.output.LayerNorm)
    return att_ln, out, LayerActs(q, k, v, scaled, probs, ctx, dense_out,
                                  att_mid, inter_pre, inter_g, dense2,
                                  probs_m)


class Residuals(NamedTuple):
    """What the reverse pass needs (JAX ``bert.Residuals``), batched."""
    x0: Tensor               # embedding output (B, S, D)
    x_ins: List[Tensor]      # per layer: input (B, S, D)
    att_lns: List[Tensor]    # per layer: post-attention LayerNorm output
    seq_out: Tensor          # encoder output (B, S, D)
    first_tok: Tensor        # pooler input (B, D)
    pooled: Tensor           # classifier input (B, D)
    ext_mask: Tensor         # (B, S) additive mask
    # slim rich anchors, per layer (kernel path only): pre-bias q|k|v
    # products (B, S, 3D), context (B, S, D), attention dense (B, S, D)
    qkv_pres: Optional[List[Tensor]] = None
    ctxs: Optional[List[Tensor]] = None
    dense_nbs: Optional[List[Tensor]] = None
    # the per-layer post-softmax probabilities (B, L, h, S, S), before any
    # head mask (plain path, when asked for)
    probs: Optional[Tensor] = None


def embed(model: BertForSequenceClassification, input_ids: Tensor,
          token_type_ids: Optional[Tensor] = None) -> Tensor:
    """Word + position + token-type embedding and LayerNorm (JAX
    ``bert.embed`` with positions ``arange(S)``); ``token_type_ids`` (B, S)
    default to 0."""
    e = model.bert.embeddings
    S = input_ids.shape[1]
    pos = torch.arange(S, device=input_ids.device)
    types = e.token_type_embeddings.weight
    x = (e.word_embeddings.weight[input_ids]
         + e.position_embeddings.weight[pos]
         + (types[0] if token_type_ids is None else types[token_type_ids]))
    return _layernorm(x, e.LayerNorm)


def forward_collect(model: BertForSequenceClassification, input_ids: Tensor,
                    attention_mask: Tensor, ops: K.BertOps = K.BERT_KERNEL_OPS,
                    use_kernel: bool = False,
                    matmul_precision: str = "float32",
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    token_type_ids: Optional[Tensor] = None,
                    head_mask: Optional[Tensor] = None,
                    keep_probs: bool = False
                    ) -> Tuple[Tensor, Residuals]:
    """Forward pass returning logits ``(B, num_labels)`` and the residuals
    (JAX ``bert.forward_collect``). ``use_kernel`` runs one
    ``bert_layer_fwd_core`` per layer with the slim rich anchors (JAX
    ``use_kernel=True, rich_anchors=True``), else the plain layers, which
    take a head mask ``(L, h)`` and, with ``keep_probs``, keep every
    layer's probabilities in ``Residuals.probs``; they run at the
    ``matmul_precision`` base with the attention island, and JAX's plain
    layers take no ``mlp_precision``."""
    cfg = model.cfg
    x0 = embed(model, input_ids, token_type_ids)
    ext_mask = (1.0 - attention_mask.to(x0.dtype)) * cfg.mask_value
    layers = model.bert.encoder.layer
    x = x0
    keep = {k: [] for k in ("x_ins", "att_lns", "qkv_pres", "ctxs",
                            "dense_nbs", "probs")}
    if use_kernel:
        _check_kernel_path(cfg, head_mask)
        if keep_probs:
            raise ValueError("the layer kernels keep no probabilities")
        mxu = matmul_precision
        attn_mxu = prec.mxu_name(attn_precision, mxu)
        mlp_mxu = mlp_precision and prec.mxu_name(mlp_precision)
        for i in range(cfg.num_layers):
            outs = ops.bert_layer_fwd_core(
                x, ext_mask, model.layer_params(i, mxu), cfg.num_heads,
                cfg.head_dim, cfg.layer_norm_eps, mxu, attn_mxu, mlp_mxu,
                save_attn=True)
            keep["x_ins"].append(x)
            for k, t in zip(list(keep)[1:], outs[1:]):
                keep[k].append(t)
            x = outs[0]
        keep["probs"] = None
    else:
        pol = prec.Policy.resolve(matmul_precision, attn_precision)
        for li, layer in enumerate(layers):
            att_ln, out, acts = layer_acts(x, None, layer, ext_mask, cfg,
                                           _layer_mask(head_mask, li), pol)
            keep["x_ins"].append(x)
            keep["att_lns"].append(att_ln)
            if keep_probs:
                keep["probs"].append(acts.probs)
            x = out
        for k in ("qkv_pres", "ctxs", "dense_nbs"):
            keep[k] = None
        keep["probs"] = (torch.stack(keep["probs"], dim=1) if keep_probs
                         else None)
    # the pooler and the classifier at the plain path's base (exact on the
    # kernel path, as before it)
    head_mode = "float32" if use_kernel else prec.mxu_name(matmul_precision)
    first_tok = x[:, 0]
    pooled = torch.tanh(_lin(first_tok, model.bert.pooler.dense, head_mode))
    logits = _lin(pooled, model.classifier, head_mode)
    return logits, Residuals(x0, seq_out=x, first_tok=first_tok,
                             pooled=pooled, ext_mask=ext_mask, **keep)


def _dropout(x: Tensor, rate: float,
             generator: Optional[torch.Generator]) -> Tensor:
    """Inverted dropout (JAX ``bert._dropout``): each element kept with
    probability ``1 − rate`` and scaled by ``1 / (1 − rate)``, the mask
    drawn from ``generator`` (on ``x``'s device). Rate 0 draws nothing."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < keep
    return torch.where(mask, x / keep, 0.0)


def train_forward(model: BertForSequenceClassification, input_ids: Tensor,
                  attention_mask: Tensor,
                  generator: Optional[torch.Generator] = None,
                  hidden_dropout: float = 0.1,
                  attn_dropout: float = 0.1) -> Tensor:
    """The training forward (JAX ``bert.train_forward``, batched): logits
    ``(B, num_labels)`` under autograd with dropout at the Hugging Face
    sites: after the embeddings, on the attention probabilities, after
    the attention output dense and the output dense of each layer (before
    their residual adds), and on the pooled output: 3·L + 2 sites, each
    mask from ``generator``. Token types are 0 and positions ``arange(S)``,
    as in JAX. Plain PyTorch in the parameters' dtype, no kernel; the
    explain path (:func:`forward_collect`) keeps no dropout."""
    cfg = model.cfg
    x = _dropout(embed(model, input_ids), hidden_dropout, generator)
    ext_mask = (1.0 - attention_mask.to(x.dtype)) * cfg.mask_value
    for layer in model.bert.encoder.layer:
        sa, ao = layer.attention.self, layer.attention.output
        q = _heads(_lin(x, sa.query), cfg)
        k = _heads(_lin(x, sa.key), cfg)
        v = _heads(_lin(x, sa.value), cfg)
        scaled = (q @ k.transpose(-1, -2)) / math.sqrt(cfg.head_dim)
        probs = torch.softmax(scaled + ext_mask[:, None, None, :], dim=-1)
        probs = _dropout(probs, attn_dropout, generator)
        dense_out = _dropout(_lin(bm.merge_heads(probs @ v), ao.dense),
                             hidden_dropout, generator)
        att_ln = _layernorm(dense_out + x, ao.LayerNorm)
        inter_g = _act(_lin(att_ln, layer.intermediate.dense),
                       cfg.hidden_act)
        dense2 = _dropout(_lin(inter_g, layer.output.dense), hidden_dropout,
                          generator)
        x = _layernorm(dense2 + att_ln, layer.output.LayerNorm)
    pooled = torch.tanh(_lin(x[:, 0], model.bert.pooler.dense))
    pooled = _dropout(pooled, hidden_dropout, generator)
    return _lin(pooled, model.classifier)


# ---------------------------------------------------------------------------
# Reverse: hand-written gradients + LRP relevance, layer by layer
# ---------------------------------------------------------------------------

def _layernorm_bwd(g_y: Tensor, x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """Cotangent of LayerNorm w.r.t. its input (JAX ``vit._layernorm_bwd``)."""
    return bm.ln_bwd(g_y, x, *bm.ln_stats(x, ln.eps), ln.weight)


def _layer_mask(head_mask: Optional[Tensor], li: int) -> Optional[Tensor]:
    return None if head_mask is None else head_mask[li]


def _check_kernel_path(cfg: BertConfig, head_mask: Optional[Tensor]) -> None:
    """What JAX's kernel branch asserts of the model."""
    if head_mask is not None:
        raise ValueError("head_mask runs on the plain path only, as in JAX")
    if cfg.hidden_act != "gelu":
        raise ValueError("the layer kernels run exact GELU only; "
                         f"{cfg.hidden_act!r} takes the plain path")


def layer_backward(g_out: Tensor, x_in: Tensor, att_ln: Tensor,
                   acts: LayerActs, layer: BertLayer, cfg: BertConfig,
                   head_mask: Optional[Tensor] = None,
                   pol: prec.Policy = prec.EXACT
                   ) -> Tuple[Tensor, Tensor]:
    """Hand-written VJP of one layer from its activations (JAX
    ``bert.layer_backward``): ``(g_in, g_probs)``, ``g_probs`` the
    cotangent of the post-softmax probabilities before the head mask
    ``(h,)`` (so it carries the mask's factor). The attention chain's
    products run in ``pol.attn``, the Linear gradients at ``pol.base``."""
    out_d, ao_d = layer.output.dense, layer.attention.output.dense
    base, ap = pol.base, pol.attn

    def mm(a, b, mode):
        return prec.product(a, b, mode)

    g_sum2 = _layernorm_bwd(g_out, acts.dense2 + att_ln,
                            layer.output.LayerNorm)
    g_ig = mm(g_sum2, out_d.weight, base)
    g_h1 = g_ig * _act_grad(acts.inter_pre, cfg.hidden_act)
    g_attln = g_sum2 + mm(g_h1, layer.intermediate.dense.weight, base)

    g_sum1 = _layernorm_bwd(g_attln, acts.att_mid,
                            layer.attention.output.LayerNorm)
    g_o = _heads(mm(g_sum1, ao_d.weight, base), cfg)
    g_probs = mm(g_o, acts.v.transpose(-1, -2), ap)
    probs_av = acts.probs if acts.probs_m is None else acts.probs_m
    g_v = mm(probs_av.transpose(-1, -2), g_o, ap)
    if acts.probs_m is not None:
        g_probs = g_probs * head_mask[:, None, None]
    inner = (g_probs * acts.probs).sum(dim=-1, keepdim=True)
    g_raw = (acts.probs * (g_probs - inner)) / math.sqrt(cfg.head_dim)
    g_q = mm(g_raw, acts.k, ap)
    g_k = mm(g_raw.transpose(-1, -2), acts.q, ap)
    sa = layer.attention.self
    g_in = (g_sum1 + mm(bm.merge_heads(g_q), sa.query.weight, base)
            + mm(bm.merge_heads(g_k), sa.key.weight, base)
            + mm(bm.merge_heads(g_v), sa.value.weight, base))
    return g_in, g_probs


def layer_relprop(R: Tensor, x_in: Tensor, att_ln: Tensor, acts: LayerActs,
                  layer: BertLayer, ext_mask: Tensor, cfg: BertConfig,
                  alpha: float = 1.0, variant: str = "ours",
                  head_mask: Optional[Tensor] = None,
                  pol: prec.Policy = prec.EXACT
                  ) -> Tuple[Tensor, Tensor]:
    """LRP through one layer (JAX ``bert.layer_relprop``): ``(R_in,
    attn_cam)``, every rule product in ``pol.rule`` (``acts`` are the
    forward's, recomputed outside the rule island as JAX does). With a
    head mask ``(h,)`` the AV split is followed by the z-rule through the
    mask's product, keeping the probabilities' share."""
    rule = pol.rule
    out_d, inter_d = layer.output.dense, layer.intermediate.dense
    ao_d, sa = layer.attention.output.dense, layer.attention.self
    # BertOutput: LN(id) -> add split -> dense
    R1, R2 = rp.add_relprop(acts.dense2, att_ln, R, variant)
    R1 = rp.linear_alphabeta(acts.inter_g, out_d.weight.t(), R1, alpha,
                             variant, y_pre=acts.dense2 - out_d.bias,
                             mode=rule)
    # BertIntermediate: act(id) -> dense
    R1 = rp.linear_alphabeta(att_ln, inter_d.weight.t(), R1, alpha, variant,
                             y_pre=acts.inter_pre - inter_d.bias, mode=rule)
    R_att = rp.clone_relprop(att_ln, [R1, R2])

    # BertSelfOutput: LN(id) -> add split -> dense
    R1, R2 = rp.add_relprop(acts.dense_out, x_in, R_att, variant)
    R1 = rp.linear_alphabeta(acts.ctx, ao_d.weight.t(), R1, alpha, variant,
                             y_pre=acts.dense_out - ao_d.bias, mode=rule)

    # BertSelfAttention
    cam = _heads(R1, cfg)
    cam1, cam_v = rp.einsum_av_relprop(
        acts.probs if acts.probs_m is None else acts.probs_m, acts.v, cam,
        rule)
    cam1 = cam1 / 2
    cam_v = cam_v / 2
    if acts.probs_m is not None:
        cam1, _ = rp.mul_relprop(acts.probs, head_mask[:, None, None]
                                 .expand_as(acts.probs), cam1)
    attn_cam = cam1
    # the attention-mask Add (masked scores = scaled + ext_mask)
    cam1, _ = rp.add_relprop(acts.scaled, ext_mask[:, None, None, :]
                             .expand_as(acts.scaled), cam1, variant)
    cam_q, cam_k = rp.einsum_qk_relprop(acts.q, acts.k, cam1, rule)
    cam_q = cam_q / 2
    cam_k = cam_k / 2
    Rs = [rp.linear_alphabeta(x_in, lin.weight.t(), bm.merge_heads(c), alpha,
                              variant, y_pre=bm.merge_heads(t) - lin.bias,
                              mode=rule)
          for lin, c, t in ((sa.query, cam_q, acts.q), (sa.key, cam_k, acts.k),
                            (sa.value, cam_v, acts.v))]
    R_h1 = rp.clone_relprop(x_in, Rs)                  # 3-way clone
    R_in = rp.clone_relprop(x_in, [R_h1, R2])          # 2-way clone
    return R_in, attn_cam


def reverse_pass(model: BertForSequenceClassification, res: Residuals,
                 onehot: Tensor, ops: K.BertOps = K.BERT_KERNEL_OPS,
                 use_kernel: bool = False, matmul_precision: str = "float32",
                 relprop_precision: Optional[str] = None,
                 attn_precision: Optional[str] = None,
                 mlp_precision: Optional[str] = None, alpha: float = 1.0,
                 variant: str = "ours", need_grads: bool = True,
                 need_relprop: bool = True, fuse_grad_cam: bool = False,
                 head_mask: Optional[Tensor] = None
                 ) -> Tuple[Optional[Tensor], Optional[Tensor],
                            Optional[Tensor]]:
    """The reverse pass (JAX ``bert.reverse_pass``): the class gradient of
    ``onehot · logits`` w.r.t. every layer's post-softmax probabilities
    (``need_grads``) and the LRP relevance (``need_relprop``, the rule
    ``variant`` at ``alpha``), advancing together layer by layer. Returns
    ``(R_tokens (B, S, D), attn_cams, attn_grads)``: the relevance at the
    layer-0 input, and per layer the relevance map and the gradient of the
    probabilities, ``(B, L, h, S, S)`` each; ``None`` for a pass not asked
    for. ``fuse_grad_cam`` folds the two into the head-mean ``(grad ⊙
    cam)⁺`` map per layer, returned ``(B, L, S, S)`` in place of
    ``attn_cams`` (``attn_grads`` None). The kernel branch (``use_kernel``:
    both passes, variant ``ours``, α=1, exact GELU, no head mask) always
    returns that fused form."""
    cfg = model.cfg
    pool, cls = model.bert.pooler.dense, model.classifier
    if use_kernel:
        _check_kernel_path(cfg, head_mask)
        if not (need_grads and need_relprop and variant == "ours"
                and alpha == 1.0):
            raise ValueError("the layer kernels run both passes with "
                             "variant 'ours' at alpha 1")
    elif fuse_grad_cam and not (need_grads and need_relprop):
        raise ValueError("fuse_grad_cam needs both passes")

    # the seeds at the plain path's base, outside the rule island (exact on
    # the kernel path, as before it)
    seed = "float32" if use_kernel else prec.mxu_name(matmul_precision)
    g = R = None
    if need_grads:
        # gradient seed: classifier -> tanh pooler -> first token
        g_pooled = prec.product(onehot, cls.weight, seed)
        t = res.pooled
        g_first = prec.product(g_pooled * (1.0 - t * t), pool.weight, seed)
        g = torch.zeros_like(res.seq_out)
        g[:, 0] = g_first
    if need_relprop:
        # relevance seed: classifier and pooler rules, then the first-token
        # index_select
        R = rp.linear_alphabeta(res.pooled, cls.weight.t(), onehot, alpha,
                                variant, mode=seed)
        R = rp.linear_alphabeta(res.first_tok, pool.weight.t(), R, alpha,
                                variant, mode=seed)
        R = rp.index_select_relprop(res.seq_out, 1, 0, R[:, None, :])

    cams: List[Optional[Tensor]] = [None] * cfg.num_layers
    grads: List[Optional[Tensor]] = [None] * cfg.num_layers
    layers = model.bert.encoder.layer
    if use_kernel:
        mxu = matmul_precision
        attn_mxu = prec.mxu_name(attn_precision, mxu)
        rule_mxu = prec.mxu_name(relprop_precision, mxu)
        mlp_mxu = mlp_precision and prec.mxu_name(mlp_precision)
        for li in reversed(range(cfg.num_layers)):
            p = model.layer_params(li, mxu)
            saved = None
            if res.qkv_pres is not None:
                saved = (res.qkv_pres[li], res.ctxs[li], res.dense_nbs[li])
            g_attln, R_att = ops.bert_out_rev_core(
                res.att_lns[li], g, R, p, cfg.layer_norm_eps, mxu, rule_mxu,
                mlp_mxu)
            g, R, cams[li] = ops.bert_attn_rev_core(
                res.x_ins[li], g_attln, R_att, res.ext_mask, p, cfg.num_heads,
                cfg.head_dim, cfg.layer_norm_eps, mxu, attn_mxu, rule_mxu,
                saved)
        return R, torch.stack(cams, dim=1), None

    pol = prec.Policy.resolve(matmul_precision, attn_precision,
                              relprop_precision)
    for li in reversed(range(cfg.num_layers)):
        x_in, att_ln = res.x_ins[li], res.att_lns[li]
        hm = _layer_mask(head_mask, li)
        _, _, acts = layer_acts(x_in, att_ln, layers[li], res.ext_mask, cfg,
                                hm, pol)
        if need_grads:
            g, grads[li] = layer_backward(g, x_in, att_ln, acts, layers[li],
                                          cfg, hm, pol)
        if need_relprop:
            R, cams[li] = layer_relprop(R, x_in, att_ln, acts, layers[li],
                                        res.ext_mask, cfg, alpha, variant, hm,
                                        pol)
        if fuse_grad_cam:
            cams[li] = (grads[li] * cams[li]).clamp(min=0).mean(dim=1)
            grads[li] = None
    stack = lambda ts: None if ts[0] is None else torch.stack(ts, dim=1)
    return R, stack(cams), stack(grads)


def relprop(model: BertForSequenceClassification, res: Residuals,
            R_logits: Tensor, alpha: float = 1.0, variant: str = "ours",
            head_mask: Optional[Tensor] = None,
            matmul_precision: str = "float32",
            relprop_precision: Optional[str] = None,
            attn_precision: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Relevance only, classifier down to the layer-0 input (JAX
    ``bert.relprop``): ``(R_tokens (B, S, D), attn_cams (B, L, h, S, S))``
    from the plain residuals; ``head_mask`` is the ``(L, h)`` mask the
    forward ran with. The precisions are those JAX's ambient
    ``default_matmul_precision`` and islands give it (exact by
    default)."""
    R_tokens, attn_cams, _ = reverse_pass(
        model, res, R_logits, alpha=alpha, variant=variant, need_grads=False,
        head_mask=head_mask, matmul_precision=matmul_precision,
        relprop_precision=relprop_precision, attn_precision=attn_precision)
    return R_tokens, attn_cams


__all__ = [
    "BertConfig", "BERT_BASE_UNCASED", "BertModel",
    "BertForSequenceClassification", "init_params", "LayerActs",
    "layer_acts", "Residuals", "embed", "forward_collect",
    "layer_backward", "layer_relprop", "reverse_pass", "relprop",
]
