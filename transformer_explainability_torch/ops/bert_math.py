"""Plain PyTorch versions of the BERT layer kernels B7, B8 and B9.

Port of the kernel-body math of
``transformer_explainability_tpu/ops/pallas_kernels.py`` (each function
names its counterpart), with a leading batch dimension written out:

  * :func:`bert_layer_fwd_core_plain` = ``_bert_fwd_math``: one post-norm
    BERT encoder layer forward with the additive attention mask, optionally
    with the rich anchors;
  * :func:`bert_out_rev_core_plain` = ``_bert_out_rev_math``: the reverse
    of the output sub-block (class gradient and every LRP rule of it);
  * :func:`bert_attn_rev_core_plain` = ``_bert_attn_rev_math`` in its
    ``unroll=False`` form: the reverse of the masked attention sub-block,
    with the mask-Add renormalisation λ and the head-mean
    ``(grad ⊙ cam)⁺`` map.

These are the CPU path of the wrappers in :mod:`.kernels` and the oracle the
CUDA kernels ``csrc/bert_fwd.cu``, ``csrc/bert_out_rev.cu`` and
``csrc/bert_attn_rev.cu`` are held to. Every product goes through
:func:`.precision.kdot` in the mode the caller names; the weights are the
prepared splits of :class:`BertLayerParams`. The q, k and v weights are one
concatenated ``(3D, D)`` weight, so the three products are one and
``qkv_pre`` comes out in JAX's concatenated layout; the rules are variant
``ours`` at α=1. ``mask`` is the ``(B, S)`` additive mask
``(1 − attention_mask) · mask_value``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from transformer_explainability_torch.ops.block_math import (
    Prepared, add_rule_math, gelu_exact, gelu_grad, linear_rule_math, ln_fwd,
    merge_heads, split_heads, to_heads)
from transformer_explainability_torch.ops.precision import kdot, transpose
from transformer_explainability_torch.ops.relprop import safe_divide

Tensor = torch.Tensor


class BertLayerParams(NamedTuple):
    """One layer's parameters as the kernels take them: LayerNorm scales and
    biases and Linear biases in the activations' dtype, and the four weights
    prepared once (JAX ``prepare_bert_weights``) in the ``nn.Linear`` layout
    ``(out, in)``: ``w_qkv`` is query, key and value stacked ``(3D, D)``,
    ``w_ao`` the attention output dense, ``w_i`` the intermediate dense
    ``(I, D)`` and ``w_o`` the output dense ``(D, I)``. The field order is
    :class:`.block_math.BlockParams`' (the kernels share its C layout)."""
    attn_ln_s: Tensor
    attn_ln_b: Tensor
    out_ln_s: Tensor
    out_ln_b: Tensor
    b_qkv: Tensor
    b_ao: Tensor
    b_i: Tensor
    b_o: Tensor
    w_qkv: Prepared
    w_ao: Prepared
    w_i: Prepared
    w_o: Prepared


def ln_bwd_math(g_y: Tensor, x: Tensor, s: Tensor, eps: float) -> Tensor:
    """JAX ``_ln_bwd_math``: the LayerNorm cotangent w.r.t. its input, from
    statistics of ``x`` taken here."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x - mu) * inv
    gg = g_y * s
    return inv * (gg - gg.mean(dim=-1, keepdim=True)
                  - xhat * (gg * xhat).mean(dim=-1, keepdim=True))


def _mask4(mask: Tensor) -> Tensor:
    """(B, S) additive mask -> (B, 1, 1, S), over the key axis."""
    return mask[:, None, None, :]


def attn_head_fwd(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                  inv_s: float, attn_mxu: str):
    """JAX ``_attn_head_fwd`` over all heads at once: ``q, k, v (B, h, S,
    hd)`` -> ``(out, raw, probs)``; ``raw`` is pre-scale."""
    raw = kdot(q, k.transpose(-1, -2), attn_mxu)
    probs = torch.softmax(raw * inv_s + _mask4(mask), dim=-1)
    return kdot(probs, v, attn_mxu), raw, probs


def attn_head_rev(q: Tensor, k: Tensor, v: Tensor, ctx: Tensor, g_o: Tensor,
                  R1: Tensor, mask: Tensor, inv_s: float, attn_mxu: str,
                  rule_mxu: str, saved_rp: Optional[Tuple[Tensor, Tensor]]
                  = None):
    """JAX ``_attn_head_rev`` over all heads at once (``(B, h, S, hd)``
    operands): the heads' backward and z-rules. Returns ``(gq, gk, gv, cqu,
    cku, cv, gc_c, a_sum, b_sum, r_sum)``; the three sums of the mask-Add
    rule are per sample, over every head and all of ``(S, S)``."""
    if saved_rp is not None:
        raw, probs = saved_rp
        scaled = raw * inv_s
    else:
        raw = kdot(q, k.transpose(-1, -2), attn_mxu)
        scaled = raw * inv_s
        probs = torch.softmax(scaled + _mask4(mask), dim=-1)
    g_probs = kdot(g_o, v.transpose(-1, -2), attn_mxu)
    gv = kdot(probs.transpose(-1, -2), g_o, attn_mxu)
    inner = (g_probs * probs).sum(dim=-1, keepdim=True)
    g_raw = probs * (g_probs - inner) * inv_s
    gq = kdot(g_raw, k, attn_mxu)
    gk = kdot(g_raw.transpose(-1, -2), q, attn_mxu)

    S1 = safe_divide(R1, ctx)
    cam1 = probs * kdot(S1, v.transpose(-1, -2), rule_mxu) * 0.5
    cv = v * kdot(probs.transpose(-1, -2), S1, rule_mxu) * 0.5
    gc_c = (g_probs * cam1).clamp(min=0)

    Zm = scaled + _mask4(mask)
    Sm = safe_divide(cam1, Zm)
    M = scaled * Sm
    S2u = safe_divide(M, raw)
    cqu = q * kdot(S2u, k, rule_mxu) * 0.5
    cku = k * kdot(S2u.transpose(-1, -2), q, rule_mxu) * 0.5

    def total(x):
        return x.sum(dim=(1, 2, 3))
    return (gq, gk, gv, cqu, cku, cv, gc_c, total(M),
            total(_mask4(mask) * Sm), total(cam1))


def bert_layer_fwd_core_plain(x: Tensor, mask: Tensor, p: BertLayerParams,
                              num_heads: int, head_dim: int, eps: float,
                              mxu: str, attn_mxu: str,
                              mlp_mxu: Optional[str] = None,
                              save_attn: bool = False,
                              save_probs: bool = False,
                              save_mlp: bool = False) -> Tuple[Tensor, ...]:
    """JAX ``_bert_fwd_math`` on ``x (B, S, D)``: returns ``(out, att_ln)``;
    with ``save_attn`` also the slim anchors ``(qkv_pre (B, S, 3D), ctx,
    dense_nb (B, S, D))``, with ``save_probs`` the fat ``(dots, probs)``
    (each ``(B, h·S, S)``, dots pre-scale) inserted after ``qkv_pre``, and
    with ``save_mlp`` ``(inter_pre_nb (B, S, I), dense2_nb (B, S, D))``
    appended. Products are pre-bias."""
    if (save_probs or save_mlp) and not save_attn:
        raise ValueError("save_probs/save_mlp require save_attn")
    b, S, _ = x.shape
    qkv_pre = kdot(x, transpose(p.w_qkv), mxu)
    q, k, v = split_heads(qkv_pre + p.b_qkv, num_heads, head_dim)
    out_h, raw, probs = attn_head_fwd(q, k, v, mask, head_dim ** -0.5,
                                      attn_mxu)
    ctx = merge_heads(out_h)
    mmx = mlp_mxu or mxu
    dense_nb = kdot(ctx, transpose(p.w_ao), mxu)
    att_ln, _, _ = ln_fwd((dense_nb + p.b_ao) + x, p.attn_ln_s, p.attn_ln_b,
                          eps)
    inter_pre_nb = kdot(att_ln, transpose(p.w_i), mmx)
    inter_g = gelu_exact(inter_pre_nb + p.b_i)
    dense2_nb = kdot(inter_g, transpose(p.w_o), mmx)
    out, _, _ = ln_fwd((dense2_nb + p.b_o) + att_ln, p.out_ln_s, p.out_ln_b,
                       eps)
    outs = (out, att_ln)
    if save_attn:
        outs += (qkv_pre,)
        if save_probs:
            outs += (raw.reshape(b, num_heads * S, S),
                     probs.reshape(b, num_heads * S, S))
        outs += (ctx, dense_nb)
    if save_mlp:
        outs += (inter_pre_nb, dense2_nb)
    return outs


def bert_out_rev_core_plain(att_ln: Tensor, g_out: Tensor, R: Tensor,
                            p: BertLayerParams, eps: float, mxu: str,
                            rule_mxu: str, mlp_mxu: Optional[str] = None,
                            saved_mlp: Optional[Tuple[Tensor, Tensor]] = None
                            ) -> Tuple[Tensor, Tensor]:
    """JAX ``_bert_out_rev_math`` on ``(B, S, D)`` tensors: the reverse of
    ``out = LN(dense2 + att_ln)`` and the MLP under it; returns ``(g_attln,
    R_att)``. ``saved_mlp = (inter_pre_nb, dense2_nb)`` skips the two
    forward-recompute products."""
    mmx = mlp_mxu or mxu
    if saved_mlp is not None:
        inter_pre_nb, dense2_nb = saved_mlp
    else:
        inter_pre_nb = kdot(att_ln, transpose(p.w_i), mmx)
    inter_pre = inter_pre_nb + p.b_i
    inter_g = gelu_exact(inter_pre)
    if saved_mlp is None:
        dense2_nb = kdot(inter_g, transpose(p.w_o), mmx)
    dense2 = dense2_nb + p.b_o

    g_sum2 = ln_bwd_math(g_out, dense2 + att_ln, p.out_ln_s, eps)
    g_ig = kdot(g_sum2, p.w_o, mmx)
    g_h1 = g_ig * gelu_grad(inter_pre)
    g_attln = g_sum2 + kdot(g_h1, p.w_i, mmx)

    R1, R2 = add_rule_math(dense2, att_ln, R)
    R1 = linear_rule_math(inter_g, p.w_o, R1, dense2_nb, rule_mxu)
    R1 = linear_rule_math(att_ln, p.w_i, R1, inter_pre_nb, rule_mxu)
    return g_attln, att_ln * safe_divide(R1 + R2, att_ln)


def bert_attn_rev_core_plain(x_in: Tensor, g_attln: Tensor, R_att: Tensor,
                             mask: Tensor, p: BertLayerParams,
                             num_heads: int, head_dim: int, eps: float,
                             mxu: str, attn_mxu: str, rule_mxu: str,
                             saved: Optional[Tuple[Tensor, ...]] = None
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """JAX ``_bert_attn_rev_math`` (``unroll=False``) on ``(B, S, D)``
    tensors: returns ``(g_in, R_in, gc (B, S, S))``. ``saved`` is the slim
    ``(qkv_pre, ctx, dense_nb)`` or the fat ``(qkv_pre, dots, probs, ctx,
    dense_nb)`` anchor set of :func:`bert_layer_fwd_core_plain`; without it
    the sub-block's forward is recomputed."""
    b, S, D = x_in.shape
    h, d = num_heads, head_dim
    inv_s = head_dim ** -0.5
    saved_rp = None
    if saved is not None:
        if len(saved) == 5:
            qkv_pre, dots, probs, ctx, dense_nb = saved
            saved_rp = (dots.reshape(b, h, S, S), probs.reshape(b, h, S, S))
        else:
            qkv_pre, ctx, dense_nb = saved
    else:
        qkv_pre = kdot(x_in, transpose(p.w_qkv), mxu)
    q, k, v = split_heads(qkv_pre + p.b_qkv, h, d)
    if saved is None:
        ctx = merge_heads(attn_head_fwd(q, k, v, mask, inv_s, attn_mxu)[0])
        dense_nb = kdot(ctx, transpose(p.w_ao), mxu)
    dense_out = dense_nb + p.b_ao
    g_sum1 = ln_bwd_math(g_attln, dense_out + x_in, p.attn_ln_s, eps)
    g_ctx = kdot(g_sum1, p.w_ao, mxu)

    R1, R2 = add_rule_math(dense_out, x_in, R_att)
    R1f = linear_rule_math(ctx, p.w_ao, R1, dense_nb, rule_mxu)

    (gq, gk, gv, cqu, cku, cv, gc_c, a_sum, b_sum, r_sum) = attn_head_rev(
        q, k, v, to_heads(ctx, h, d), to_heads(g_ctx, h, d),
        to_heads(R1f, h, d), mask, inv_s, attn_mxu, rule_mxu, saved_rp)
    gc = gc_c.sum(dim=1) / num_heads
    tot = a_sum.abs() + b_sum.abs()
    a_fact = safe_divide(a_sum.abs(), tot) * r_sum
    lam = safe_divide(a_fact, a_sum)[:, None, None]
    cam_qkv = torch.cat([lam * merge_heads(cqu), lam * merge_heads(cku),
                         merge_heads(cv)], dim=-1)
    g_qkv = torch.cat([merge_heads(gq), merge_heads(gk), merge_heads(gv)],
                      dim=-1)
    R_lin = linear_rule_math(x_in, p.w_qkv, cam_qkv, qkv_pre, rule_mxu)
    g_in = g_sum1 + kdot(g_qkv, p.w_qkv, mxu)
    # two nested clones, as the reference (BERT.py:319, :227)
    R_h1 = x_in * safe_divide(R_lin, x_in)
    R_in = x_in * safe_divide(R_h1 + R2, x_in)
    return g_in, R_in, gc


__all__ = ["BertLayerParams", "ln_bwd_math", "attn_head_fwd",
           "attn_head_rev", "bert_layer_fwd_core_plain",
           "bert_out_rev_core_plain", "bert_attn_rev_core_plain"]
