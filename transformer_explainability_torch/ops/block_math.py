"""Plain PyTorch versions of the ViT block megakernels B2 and B3.

Port of the kernel-body math of
``transformer_explainability_tpu/ops/pallas_kernels.py`` (each function
names its counterpart), with a leading batch dimension written out:

  * :func:`block_fwd_core_plain` = ``_block_fwd_math``: one whole ViT block
    forward, optionally with the rich anchors;
  * :func:`block_rev_core_plain` = ``_block_rev_math``: the whole fused
    reverse step of one block (class gradient, every LRP rule of the block,
    the head-mean ``(grad ⊙ cam)⁺`` map), from the 6-anchor ``saved`` form
    or by recompute.

These are the CPU path of the wrappers in :mod:`.kernels` and the oracle
the CUDA kernels ``csrc/block_fwd.cu`` and ``csrc/block_rev.cu`` are held
to. Every product goes through :func:`.precision.kdot` in the mode the
caller names (:func:`.precision.product` in the MLP half and the linear
rule, which the plain paths share); weights are the prepared splits of
:class:`BlockParams`.
The rules are variant ``ours`` at α=1, the only ones the megakernels run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from transformer_explainability_torch.ops.precision import (
    kabs, kdot, product, transpose)
from transformer_explainability_torch.ops.relprop import safe_divide

Tensor = torch.Tensor
Prepared = Tuple[Tensor, ...]


class BlockParams(NamedTuple):
    """One block's parameters as the megakernels take them: LayerNorm
    scales and biases and Linear biases in the activations' dtype, and the
    four weights prepared once (:func:`.precision.prepare_weight`) in the
    ``nn.Linear`` layout ``(out, in)``."""
    ln1s: Tensor
    ln1b: Tensor
    ln2s: Tensor
    ln2b: Tensor
    bqkv: Tensor
    bproj: Tensor
    b1: Tensor
    b2: Tensor
    wqkv: Prepared
    wproj: Prepared
    w1: Prepared
    w2: Prepared


def ln_stats(x: Tensor, eps: float) -> Tuple[Tensor, Tensor]:
    """Mean and 1/sqrt(var + eps) over the last dimension."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def ln_fwd(x: Tensor, s: Tensor, b: Tensor, eps: float):
    """JAX ``_ln_fwd``: returns ``(xn, mu, inv)``."""
    mu, inv = ln_stats(x, eps)
    return (x - mu) * inv * s + b, mu, inv


def ln_bwd(g: Tensor, x: Tensor, mu: Tensor, inv: Tensor, s: Tensor):
    """Cotangent of LayerNorm w.r.t. its input, from its statistics."""
    gg = g * s
    xhat = (x - mu) * inv
    return inv * (gg - gg.mean(dim=-1, keepdim=True)
                  - xhat * (gg * xhat).mean(dim=-1, keepdim=True))


def gelu_exact(x: Tensor) -> Tensor:
    """JAX ``_gelu_exact`` with the exact erf (``_kerf``'s polynomial is a
    TPU workaround; JAX's float64 path uses ``lax.erf`` too)."""
    return x * (0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))))


def gelu_grad(x: Tensor) -> Tensor:
    """JAX ``_gelu_grad``: Φ(x) + x·φ(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    return cdf + x * pdf


def _sample_sum(x: Tensor) -> Tensor:
    return x.sum(dim=tuple(range(1, x.ndim)), keepdim=True)


def add_rule_math(a: Tensor, b: Tensor, R: Tensor,
                  Z: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """JAX ``_add_rule_math``: the ``ours`` add rule, its sums per sample
    (over every dimension but the first)."""
    if Z is None:
        Z = a + b
    S = safe_divide(R, Z)
    Ca, Cb = a * S, b * S
    a_sum, b_sum, r_sum = _sample_sum(Ca), _sample_sum(Cb), _sample_sum(R)
    tot = a_sum.abs() + b_sum.abs()
    a_fact = safe_divide(a_sum.abs(), tot) * r_sum
    b_fact = safe_divide(b_sum.abs(), tot) * r_sum
    return Ca * safe_divide(a_fact, a_sum), Cb * safe_divide(b_fact, b_sum)


def linear_rule_math(x: Tensor, w: Prepared, R: Tensor, y_pre: Tensor,
                     rule_mxu: str) -> Tensor:
    """JAX ``_linear_rule_math``: the ``ours`` α-β rule at α=1 for
    ``y_pre = x @ wᵀ`` (``w`` in the ``(out, in)`` layout)."""
    ax = x.abs()
    aw = kabs(w)
    axw = product(ax, transpose(aw), rule_mxu)
    S = safe_divide(R, 0.5 * (y_pre + axw))
    return 0.5 * (x * product(S, w, rule_mxu) + ax * product(S, aw, rule_mxu))


def split_heads(qkv: Tensor, num_heads: int, head_dim: int):
    """(B, n, 3D) in 'n (qkv h d)' order -> three (B, h, n, hd) views."""
    b, n, _ = qkv.shape
    x = qkv.reshape(b, n, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def to_heads(x: Tensor, num_heads: int, head_dim: int) -> Tensor:
    """(B, n, h·hd) -> (B, h, n, hd)."""
    b, n, _ = x.shape
    return x.reshape(b, n, num_heads, head_dim).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    """(B, h, n, hd) -> (B, n, h·hd)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def merge3(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """Three (B, h, n, hd) -> (B, n, 3·h·hd) in 'n (qkv h d)' order."""
    x = torch.stack([a, b, c], dim=2)                    # (B, h, 3, n, hd)
    bsz, h, _, n, d = x.shape
    return x.permute(0, 3, 2, 1, 4).reshape(bsz, n, 3 * h * d)


def mlp_rev_math(x_mid, g_out, R, p: BlockParams, *, eps: float, mxu: str,
                 rule_mxu: str, mlp_mxu: Optional[str] = None,
                 saved_mlp: Optional[Tuple[Tensor, Tensor]] = None):
    """JAX ``_mlp_rev_math``: the MLP half of the reverse step; returns
    ``(g_mid, Rm)``. ``saved_mlp = (fc1_pre, fc2_pre)`` skips the two
    forward-recompute products."""
    mmx = mlp_mxu or mxu
    xn2, mu, inv = ln_fwd(x_mid, p.ln2s, p.ln2b, eps)
    if saved_mlp is not None:
        fc1_pre, fc2_pre = saved_mlp
    else:
        fc1_pre = product(xn2, transpose(p.w1), mmx)
    h1 = fc1_pre + p.b1
    hg = gelu_exact(h1)
    if saved_mlp is None:
        fc2_pre = product(hg, transpose(p.w2), mmx)
    mlp_out = fc2_pre + p.b2

    g_h1 = product(g_out, p.w2, mmx) * gelu_grad(h1)
    g_xn2 = product(g_h1, p.w1, mmx)
    g_mid = g_out + ln_bwd(g_xn2, x_mid, mu, inv, p.ln2s)

    Ca, Cb = add_rule_math(x_mid, mlp_out, R)
    R2 = linear_rule_math(hg, p.w2, Cb, fc2_pre, rule_mxu)
    R2b = linear_rule_math(xn2, p.w1, R2, fc1_pre, rule_mxu)
    return g_mid, x_mid * safe_divide(Ca + R2b, x_mid)


def attn_rev_math(qkv, g_o, cam_o, num_heads: int, head_dim: int,
                  scale: float, attn_mxu: str, rule_mxu: str,
                  saved_attn: Optional[Tuple[Tensor, Tensor]] = None,
                  out_m: Optional[Tensor] = None):
    """JAX ``_attn_rev_math``: the attention reverse, gradient products in
    ``attn_mxu`` and rule products in ``rule_mxu``. ``saved_attn = (dots,
    probs)``, each ``(B, h·n, n)``, skips the QKᵀ and softmax recompute;
    ``out_m (B, n, D)`` the AV one. Returns ``(g_qkv, cam_qkv, gc)``."""
    b, n, _ = qkv.shape
    q, k, v = split_heads(qkv, num_heads, head_dim)
    go = to_heads(g_o, num_heads, head_dim)
    co = to_heads(cam_o, num_heads, head_dim)
    if saved_attn is not None:
        dots, attn = (t.reshape(b, num_heads, n, n) for t in saved_attn)
    else:
        dots = kdot(q, k.transpose(-1, -2), attn_mxu)
        attn = torch.softmax(dots * scale, dim=-1)
    if out_m is not None:
        out = to_heads(out_m, num_heads, head_dim)
    else:
        out = kdot(attn, v, attn_mxu)
    g_attn = kdot(go, v.transpose(-1, -2), attn_mxu)
    g_v = kdot(attn.transpose(-1, -2), go, attn_mxu)
    inner = (g_attn * attn).sum(dim=-1, keepdim=True)
    g_dots = attn * (g_attn - inner) * scale
    g_q = kdot(g_dots, k, attn_mxu)
    g_k = kdot(g_dots.transpose(-1, -2), q, attn_mxu)
    S1 = safe_divide(co, out)
    cam1 = attn * kdot(S1, v.transpose(-1, -2), rule_mxu) * 0.5
    cam_v = v * kdot(attn.transpose(-1, -2), S1, rule_mxu) * 0.5
    S2 = safe_divide(cam1, dots)
    cam_q = q * kdot(S2, k, rule_mxu) * 0.5
    cam_k = k * kdot(S2.transpose(-1, -2), q, rule_mxu) * 0.5
    gc = (g_attn * cam1).clamp(min=0).sum(dim=1) / num_heads
    return merge3(g_q, g_k, g_v), merge3(cam_q, cam_k, cam_v), gc


def block_fwd_core_plain(x: Tensor, p: BlockParams, num_heads: int,
                         head_dim: int, eps: float, mxu: str, attn_mxu: str,
                         mlp_mxu: Optional[str] = None,
                         save_attn: bool = False, save_mlp: bool = False):
    """JAX ``_block_fwd_math`` on ``x (B, n, D)``: returns ``(x_out, x_mid,
    out_m)``; with ``save_attn`` also ``(qkv_pre (B, n, 3D), proj_pre
    (B, n, D), dots, probs (B, h·n, n))``, with ``save_mlp`` also
    ``(fc1_pre (B, n, M), fc2_pre (B, n, D))``. Pre-bias products; dots
    before the scale."""
    if save_mlp and not save_attn:
        raise ValueError("save_mlp requires save_attn")
    mmx = mlp_mxu or mxu
    b, n, _ = x.shape
    xn1, _, _ = ln_fwd(x, p.ln1s, p.ln1b, eps)
    qkv_pre = kdot(xn1, transpose(p.wqkv), mxu)
    q, k, v = split_heads(qkv_pre + p.bqkv, num_heads, head_dim)
    dots = kdot(q, k.transpose(-1, -2), attn_mxu)
    probs = torch.softmax(dots * (head_dim ** -0.5), dim=-1)
    out_m = merge_heads(kdot(probs, v, attn_mxu))
    proj_pre = kdot(out_m, transpose(p.wproj), mxu)
    x_mid = x + (proj_pre + p.bproj)
    xn2, _, _ = ln_fwd(x_mid, p.ln2s, p.ln2b, eps)
    fc1_pre = kdot(xn2, transpose(p.w1), mmx)
    hg = gelu_exact(fc1_pre + p.b1)
    fc2_pre = kdot(hg, transpose(p.w2), mmx)
    x_out = x_mid + (fc2_pre + p.b2)
    outs = (x_out, x_mid, out_m)
    if save_attn:
        outs += (qkv_pre, proj_pre, dots.reshape(b, num_heads * n, n),
                 probs.reshape(b, num_heads * n, n))
    if save_mlp:
        outs += (fc1_pre, fc2_pre)
    return outs


def block_rev_core_plain(x_in: Tensor, x_mid: Tensor, out_m: Tensor,
                         g_out: Tensor, R: Tensor, p: BlockParams,
                         num_heads: int, head_dim: int, eps: float,
                         mxu: str, attn_mxu: str, rule_mxu: str,
                         mlp_mxu: Optional[str] = None,
                         saved: Optional[Tuple[Tensor, ...]] = None):
    """JAX ``_block_rev_math`` on ``(B, n, D)`` tensors: returns ``(g_in,
    R_in, gc (B, n, n))``. ``saved`` is the 4-anchor ``(qkv_pre, proj_pre,
    dots, probs)`` or 6-anchor ``(… , fc1_pre, fc2_pre)`` output of
    :func:`block_fwd_core_plain`; without it the block is recomputed."""
    scale = head_dim ** -0.5
    xn1, mu1, inv1 = ln_fwd(x_in, p.ln1s, p.ln1b, eps)
    saved_mlp = None
    if saved is not None:
        qkv_pre, proj_pre = saved[0], saved[1]
        saved_attn, out_anchor = (saved[2], saved[3]), out_m
        if len(saved) == 6:
            saved_mlp = (saved[4], saved[5])
    else:
        qkv_pre = kdot(xn1, transpose(p.wqkv), mxu)
        proj_pre = kdot(out_m, transpose(p.wproj), mxu)
        saved_attn = out_anchor = None
    qkv = qkv_pre + p.bqkv
    attn_out = proj_pre + p.bproj

    g_mid, Rm = mlp_rev_math(x_mid, g_out, R, p, eps=eps, mxu=mxu,
                             rule_mxu=rule_mxu, mlp_mxu=mlp_mxu,
                             saved_mlp=saved_mlp)
    g_om = kdot(g_mid, p.wproj, mxu)
    # Z recomputed as x_in + attn_out, not the saved x_mid (the rule
    # assumes a + b == Z bitwise)
    Ra1, Ra2 = add_rule_math(x_in, attn_out, Rm)
    cam_o = linear_rule_math(out_m, p.wproj, Ra2, proj_pre, rule_mxu)
    g_qkv, cam_qkv, gc = attn_rev_math(qkv, g_om, cam_o, num_heads,
                                       head_dim, scale, attn_mxu, rule_mxu,
                                       saved_attn=saved_attn,
                                       out_m=out_anchor)
    g_xn1 = kdot(g_qkv, p.wqkv, mxu)
    g_in = g_mid + ln_bwd(g_xn1, x_in, mu1, inv1, p.ln1s)
    R2 = linear_rule_math(xn1, p.wqkv, cam_qkv, qkv_pre, rule_mxu)
    R_in = x_in * safe_divide(Ra1 + R2, x_in)
    return g_in, R_in, gc


__all__ = ["BlockParams", "ln_stats", "ln_fwd", "ln_bwd", "gelu_exact", "gelu_grad",
           "add_rule_math", "linear_rule_math", "mlp_rev_math",
           "attn_rev_math", "block_fwd_core_plain", "block_rev_core_plain"]
