"""Tensor parallelism (TP) for the ViT explain path over ``torch.distributed``.

Port of ``transformer_explainability_tpu/parallel/tensor.py``. Each rank of
a process group of size k holds a slice of every block's weights (its
heads' rows of qkv and columns of proj, its M/k columns of the MLP) and
runs the explain program on the whole batch; the ranks meet in
``all_reduce`` (SUM) wherever the JAX program psums over its model axis:

  * qkv column-parallel by head (the rows reshuffled by
    :func:`tp_reshuffle_params` so that a contiguous slice is one rank's
    heads in the kernels' ``'qkv h d'`` layout); the attention kernels B4
    ``attn_fwd_core`` and B5 ``attn_rev_core`` run on the local heads;
  * proj and fc2 row-parallel (all-reduce after the partial product, the
    bias added once after it); fc1 column-parallel;
  * the α-β rules follow the same split (:func:`_lin_rule_col`,
    :func:`_lin_rule_row`); the add and clone rules and the LayerNorms run
    on replicated activations;
  * with the TP MLP kernels (``mlp_kernel``, on by default for bfloat16 and
    tensorfloat32 MLP products, as in JAX) the MLP half of each reverse
    step is B10a ``mlp_rev_tp_phase1`` -> one all-reduce of the three
    stacked (B, n, D) partials -> LN backward, the add rule and the fc2
    rule's divide -> B10b ``mlp_rev_tp_phase2`` -> one all-reduce of the two
    stacked partials -> the clone merge;
  * each block's ``(grad ⊙ cam)⁺`` head-sum partials are all-reduced and
    divided by k; the rollout B1 runs on every rank.

Every product the JAX program runs under a precision context runs through
:func:`..ops.precision.kdot` in that mode (the products outside the kernels
stay library matmuls). The collectives run at every psum of the JAX
program, also at k = 1. Every rank calls the program with the same batch.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from transformer_explainability_torch.explain.generator import (
    FUSED_METHODS, _check_fp32_matmul, _one_hot_index, _resolve_device,
    check_supported)
from transformer_explainability_torch.models import vit as vit_mod
from transformer_explainability_torch.models.vit import ViTConfig
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as prec
from transformer_explainability_torch.ops import relprop as rp
from transformer_explainability_torch.ops.precision import (
    Weight, kabs, kdot, transpose)

Tensor = torch.Tensor


class TPBlock(NamedTuple):
    """One block's slice on one rank: replicated LayerNorms and row-parallel
    biases; this rank's qkv rows and bias (3D/k), proj columns (D, D/k),
    fc1 rows and bias (M/k), fc2 columns (D, M/k), in the ``nn.Linear``
    layout, as tensors (float32 mode) or prepared splits."""
    ln1s: Tensor
    ln1b: Tensor
    ln2s: Tensor
    ln2b: Tensor
    bqkv: Tensor
    bproj: Tensor
    b1: Tensor
    b2: Tensor
    wqkv: Weight
    wproj: Weight
    w1: Weight
    w2: Weight


class TPParams(NamedTuple):
    """What one rank holds: the replicated embedding, final norm and head,
    its block slices, and the split they were made for."""
    patch_weight: Tensor
    patch_bias: Tensor
    cls_token: Tensor
    pos_embed: Tensor
    norm_weight: Tensor
    norm_bias: Tensor
    head_weight: Tensor
    head_bias: Tensor
    blocks: Tuple[TPBlock, ...]
    k: int
    rank: int
    mode: str


def _check_divides(cfg: ViTConfig, k: int) -> None:
    if cfg.num_heads % k or cfg.mlp_dim % k:
        raise ValueError(f"tensor parallelism over {k} ranks needs the heads "
                         f"({cfg.num_heads}) and the MLP width "
                         f"({cfg.mlp_dim}) to divide by {k}")


def tp_reshuffle_params(params: Mapping[str, Tensor],
                        k: int) -> Dict[str, Tensor]:
    """Reorder each block's qkv weight rows and bias from ``'(qkv h d)'`` to
    ``'(shard qkv h_local d)'`` (JAX ``tp_reshuffle_params``, transposed for
    the ``(out, in)`` layout), so that rank r's rows are the contiguous slice
    r of 3D/k. Returns a new state dict; the other entries are the same
    tensors."""
    out = dict(params)
    for name, t in params.items():
        if name.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            D = t.shape[0] // 3
            out[name] = (t.reshape(3, k, D // k, *t.shape[1:])
                         .transpose(0, 1).reshape(t.shape).contiguous())
    return out


def tp_shard(params: Mapping[str, Tensor], cfg: ViTConfig, k: int, rank: int,
             mode: str = "float32", device=None) -> TPParams:
    """Rank ``rank``'s slices of a timm-named state dict for a model axis of
    size ``k``, split as JAX ``tp_param_specs`` specifies (qkv and fc1
    column-parallel, proj and fc2 row-parallel, everything else replicated),
    after :func:`tp_reshuffle_params`. The four block weights are made
    contiguous and prepared once for ``mode``
    (:func:`..ops.precision.prepare_weight`; kept as tensors for
    ``"float32"``). ``device`` moves every tensor (None: stay)."""
    _check_divides(cfg, k)
    D, M = cfg.embed_dim, cfg.mlp_dim
    if not 0 <= rank < k:
        raise ValueError(f"rank {rank} outside [0, {k})")
    sd = {n: (t if device is None else t.to(device))
          for n, t in tp_reshuffle_params(params, k).items()}

    def rows(t, width):
        return t[rank * width:(rank + 1) * width].contiguous()

    def cols(t, width):
        return t[:, rank * width:(rank + 1) * width].contiguous()

    def weight(t):
        return t if mode == "float32" else prec.prepare_weight(t, mode)

    blocks = []
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        bqkv = sd.get(p + "attn.qkv.bias")
        if bqkv is None:
            bqkv = torch.zeros_like(sd[p + "attn.proj.bias"]).repeat(3)
        blocks.append(TPBlock(
            sd[p + "norm1.weight"], sd[p + "norm1.bias"],
            sd[p + "norm2.weight"], sd[p + "norm2.bias"],
            rows(bqkv, 3 * D // k), sd[p + "attn.proj.bias"],
            rows(sd[p + "mlp.fc1.bias"], M // k), sd[p + "mlp.fc2.bias"],
            weight(rows(sd[p + "attn.qkv.weight"], 3 * D // k)),
            weight(cols(sd[p + "attn.proj.weight"], D // k)),
            weight(rows(sd[p + "mlp.fc1.weight"], M // k)),
            weight(cols(sd[p + "mlp.fc2.weight"], M // k))))
    return TPParams(sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"],
                    sd["cls_token"], sd["pos_embed"], sd["norm.weight"],
                    sd["norm.bias"], sd["head.weight"], sd["head.bias"],
                    tuple(blocks), k, rank, mode)


def _group_shape(group) -> Tuple[int, int]:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("tensor parallelism needs an initialised "
                           "torch.distributed process group (the default "
                           "one, or the group passed in)")
    return dist.get_world_size(group), dist.get_rank(group)


def shard_tp_params(params: Mapping[str, Tensor], cfg: ViTConfig,
                    group=None, mode: str = "float32",
                    device=None) -> TPParams:
    """This rank's slices of ``params`` in ``group`` (None: the default
    process group): :func:`tp_shard` at the group's size and this process's
    rank (JAX ``shard_tp_params``)."""
    k, rank = _group_shape(group)
    return tp_shard(params, cfg, k, rank, mode, device)


def _all_reduce(t: Tensor, group) -> Tensor:
    """In-place SUM over the group (the JAX program's psum)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _lin_rule_col(x: Tensor, w_l: Weight, R_l: Tensor, y_pre_l: Tensor,
                  rule_mxu: str, group) -> Tensor:
    """The ``ours`` α=1 rule of a column-parallel Linear (qkv, fc1; JAX
    ``_lin_rule_col``): the denominator is local in the output columns;
    the (B, n, D_in) relevance partials are all-reduced."""
    ax, aw = x.abs(), kabs(w_l)
    S = rp.safe_divide(R_l, 0.5 * (y_pre_l + kdot(ax, transpose(aw),
                                                  rule_mxu)))
    return _all_reduce(0.5 * (x * kdot(S, w_l, rule_mxu)
                              + ax * kdot(S, aw, rule_mxu)), group)


def _lin_rule_row(x_l: Tensor, w_l: Weight, R: Tensor, y_pre: Tensor,
                  rule_mxu: str, group) -> Tensor:
    """The ``ours`` α=1 rule of a row-parallel Linear (proj, fc2; JAX
    ``_lin_rule_row``): the denominator products are all-reduced; the
    relevance stays local in the input columns."""
    ax, aw = x_l.abs(), kabs(w_l)
    axw = _all_reduce(kdot(ax, transpose(aw), rule_mxu), group)
    S = rp.safe_divide(R, 0.5 * (y_pre + axw))
    return 0.5 * (x_l * kdot(S, w_l, rule_mxu) + ax * kdot(S, aw, rule_mxu))


def make_tp_explain_fn(cfg: ViTConfig, group=None, device="cuda",
                       method: str = "transformer_attribution",
                       start_layer: int = 0, alpha: float = 1.0,
                       variant: str = "ours",
                       matmul_precision: str = "float32",
                       attn_precision: Optional[str] = None,
                       relprop_precision: Optional[str] = None,
                       mlp_precision: Optional[str] = None,
                       pre_sharded: bool = False,
                       mlp_kernel: Optional[bool] = None,
                       rich_anchors: Optional[bool] = None,
                       ops: K.AttnOps = K.KERNEL_OPS):
    """The TP explain ``fn(params, images, indices) -> (B, num_patches)``
    (JAX ``make_tp_explain_fn``). Every rank of ``group`` (None: the default
    process group) calls it with the same ``images (B, C, H, W)`` and
    ``indices (B,)`` (−1: the argmax class); each gets the whole heatmap.

    ``params`` is the timm-named state dict (sharded on every call) or, with
    ``pre_sharded``, this rank's :func:`shard_tp_params` for
    ``matmul_precision``; its dtype is the program's. The precision
    arguments are those of ``explain.generator.PRECISION_PRESETS``.
    ``mlp_kernel`` (default: on for bfloat16 and tensorfloat32 MLP
    products) takes the TP MLP kernels B10a/B10b for the MLP half of the
    reverse; ``rich_anchors`` (default off) saves the forward's qkv and proj
    products for the reverse instead of recomputing them. ``ops`` selects
    the kernels or, for a reference run, their plain versions.

    Raises as the JAX gates do: another method, variant or α, or a
    precision combination the kernels do not run, ``NotImplementedError``;
    heads or MLP width not divisible by the group's size, ``ValueError``.
    """
    if method not in FUSED_METHODS:
        raise NotImplementedError(
            f"method {method!r}: the tensor-parallel program runs "
            "transformer_attribution, as the JAX one does; the other methods "
            "run on one device (ROADMAP A4)")
    if variant != "ours" or alpha != 1.0:
        raise NotImplementedError(
            "the tensor-parallel program runs variant 'ours' at alpha 1, as "
            "the JAX one does; the others run on one device (ROADMAP A3)")
    check_supported(method, alpha, variant, matmul_precision,
                    relprop_precision, attn_precision, mlp_precision)
    k, _ = _group_shape(group)
    _check_divides(cfg, k)
    device = _resolve_device(device)
    hd, L = cfg.head_dim, cfg.depth
    h_loc, scale, eps = cfg.num_heads // k, hd ** -0.5, cfg.block_ln_eps
    mxu = prec.mxu_name(matmul_precision)
    attn_mxu = prec.mxu_name(attn_precision, matmul_precision)
    rule_mxu = prec.mxu_name(relprop_precision, matmul_precision)
    mlp_mxu = prec.mxu_name(mlp_precision, matmul_precision)
    if mlp_kernel is None:
        mlp_kernel = mlp_mxu in ("bfloat16", "tensorfloat32")
    rich_anchors = bool(rich_anchors)

    def ln(x, s, b):
        return bm.ln_fwd(x, s, b, eps)[0]

    def ln_bwd(g, x, s):
        return bm.ln_bwd(g, x, *bm.ln_stats(x, eps), s)

    def fwd_step(x, b: TPBlock):
        qkv_pre = kdot(ln(x, b.ln1s, b.ln1b), transpose(b.wqkv), mxu)
        out_l = ops.attn_fwd_core(qkv_pre + b.bqkv, h_loc, hd, scale,
                                  mxu=attn_mxu)
        proj_pre = _all_reduce(kdot(out_l, transpose(b.wproj), mxu), group)
        x_mid = x + (proj_pre + b.bproj)
        hg = bm.gelu_exact(kdot(ln(x_mid, b.ln2s, b.ln2b), transpose(b.w1),
                                mlp_mxu) + b.b1)
        mlp_out = _all_reduce(kdot(hg, transpose(b.w2), mlp_mxu),
                              group) + b.b2
        saved = (x, x_mid, out_l) + ((qkv_pre, proj_pre) if rich_anchors
                                     else ())
        return x_mid + mlp_out, saved

    def mlp_half_kernel(x_mid, g_out, Rc, b: TPBlock):
        fc1_pre_l, *parts = ops.mlp_rev_tp_phase1(
            x_mid, g_out, b.ln2s, b.ln2b, b.b1, b.w1, b.w2, eps, mxu=mlp_mxu,
            rule_mxu=rule_mxu)
        fc2_pre, axw2, g_xn2 = _all_reduce(torch.stack(parts), group)
        g_mid = g_out + ln_bwd(g_xn2, x_mid, b.ln2s)
        R1, R2 = rp.add_relprop(x_mid, fc2_pre + b.b2, Rc)
        Sr = rp.safe_divide(R2, 0.5 * (fc2_pre + axw2))
        num_w, num_a = _all_reduce(torch.stack(ops.mlp_rev_tp_phase2(
            x_mid, Sr, fc1_pre_l, b.ln2s, b.ln2b, b.b1, b.w1, b.w2, eps,
            rule_mxu=rule_mxu)), group)
        xn2 = ln(x_mid, b.ln2s, b.ln2b)
        R2b = 0.5 * (xn2 * num_w + xn2.abs() * num_a)
        return g_mid, rp.clone_relprop(x_mid, [R1, R2b])

    def mlp_half_plain(x_mid, g_out, Rc, b: TPBlock):
        xn2 = ln(x_mid, b.ln2s, b.ln2b)
        fc1_pre_l = kdot(xn2, transpose(b.w1), mlp_mxu)
        h1_l = fc1_pre_l + b.b1
        hg_l = bm.gelu_exact(h1_l)
        fc2_pre = _all_reduce(kdot(hg_l, transpose(b.w2), mlp_mxu), group)
        g_h1_l = kdot(g_out, b.w2, mlp_mxu) * bm.gelu_grad(h1_l)
        g_xn2 = _all_reduce(kdot(g_h1_l, b.w1, mlp_mxu), group)
        g_mid = g_out + ln_bwd(g_xn2, x_mid, b.ln2s)
        R1, R2 = rp.add_relprop(x_mid, fc2_pre + b.b2, Rc)
        R2_l = _lin_rule_row(hg_l, b.w2, R2, fc2_pre, rule_mxu, group)
        R2 = _lin_rule_col(xn2, b.w1, R2_l, fc1_pre_l, rule_mxu, group)
        return g_mid, rp.clone_relprop(x_mid, [R1, R2])

    mlp_half = mlp_half_kernel if mlp_kernel else mlp_half_plain

    def rev_step(g_out, Rc, saved, b: TPBlock):
        x_in, x_mid, out_l = saved[:3]
        xn1 = ln(x_in, b.ln1s, b.ln1b)
        if rich_anchors:
            qkv_pre_l, proj_pre = saved[3:]
        else:
            qkv_pre_l = kdot(xn1, transpose(b.wqkv), mxu)
            proj_pre = _all_reduce(kdot(out_l, transpose(b.wproj), mxu),
                                   group)
        attn_out = proj_pre + b.bproj
        g_mid, Rm = mlp_half(x_mid, g_out, Rc, b)

        g_om_l = kdot(g_mid, b.wproj, mxu)
        Ra1, Ra2 = rp.add_relprop(x_in, attn_out, Rm, Z=x_mid)
        cam_o_l = _lin_rule_row(out_l, b.wproj, Ra2, proj_pre, rule_mxu,
                                group)
        g_qkv_l, cam_qkv_l, gc_l = ops.attn_rev_core(
            qkv_pre_l + b.bqkv, g_om_l, cam_o_l, h_loc, hd, scale,
            attn_mxu=attn_mxu, rule_mxu=rule_mxu)
        R2 = _lin_rule_col(xn1, b.wqkv, cam_qkv_l, qkv_pre_l, rule_mxu, group)
        g_xn1 = _all_reduce(kdot(g_qkv_l, b.wqkv, mxu), group)
        g_in = g_mid + ln_bwd(g_xn1, x_in, b.ln1s)
        return (g_in, rp.clone_relprop(x_in, [Ra1, R2]),
                _all_reduce(gc_l, group) / k)

    def program(p: TPParams, images: Tensor, indices: Tensor) -> Tensor:
        _, x = vit_mod.embed_tokens(cfg, p.patch_weight, p.patch_bias,
                                    p.cls_token, p.pos_embed, images)
        saved = []
        for b in p.blocks:
            x, s = fwd_step(x, b)
            saved.append(s)
        xn = bm.ln_fwd(x, p.norm_weight, p.norm_bias, cfg.final_ln_eps)[0]
        cls = xn[:, 0]
        logits = kdot(cls, p.head_weight.t(), mxu) + p.head_bias
        onehot = _one_hot_index(logits, indices, cfg.num_classes)

        # gradient seed through head -> CLS pool -> final LayerNorm
        g_xn = torch.zeros_like(xn)
        g_xn[:, 0] = kdot(onehot, p.head_weight, mxu)
        g = bm.ln_bwd(g_xn, x, *bm.ln_stats(x, cfg.final_ln_eps),
                      p.norm_weight)
        # relevance seed: the head rule, then the CLS index_select
        R_cls = bm.linear_rule_math(cls, p.head_weight, onehot,
                                    kdot(cls, p.head_weight.t(), rule_mxu),
                                    rule_mxu)
        R = rp.index_select_relprop(xn, 1, 0, R_cls[:, None, :])

        gcs = [None] * L
        for li in reversed(range(L)):
            g, R, gcs[li] = rev_step(g, R, saved[li], p.blocks[li])
        joint = ops.rollout_from_grad_cam(torch.stack(gcs, dim=1),
                                          start_layer, rows=1)
        return joint[:, 0, cfg.num_prefix_tokens:]

    @torch.no_grad()
    def fn(params, images, indices) -> Tensor:
        if pre_sharded:
            p = params
            if (p.k, p.mode) != (k, mxu):
                raise ValueError(f"params were sharded for k={p.k}, mode "
                                 f"{p.mode!r}; this program runs k={k}, "
                                 f"mode {mxu!r}")
        else:
            p = shard_tp_params(params, cfg, group, mxu, device)
        dtype = p.cls_token.dtype
        _check_fp32_matmul(device, dtype)
        images = torch.as_tensor(images, device=device).to(dtype)
        idx = torch.as_tensor(indices, device=device).to(torch.int64)
        return program(p, images, idx.reshape(images.shape[0]))

    return fn


__all__ = ["TPBlock", "TPParams", "tp_reshuffle_params", "tp_shard",
           "shard_tp_params", "make_tp_explain_fn"]
