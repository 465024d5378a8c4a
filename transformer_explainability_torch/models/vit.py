"""Explainable Vision Transformer in PyTorch: the fused-kernel paths.

Port of ``transformer_explainability_tpu/models/vit.py`` restricted to the
fused-kernel branches that ``transformer_attribution`` takes
(``use_attn_kernel=True``):

  * ``matmul_precision="float32"`` (exact FP32): :func:`forward_collect` is
    the JAX ``step_lite`` forward (LayerNorm and the Linear products in
    PyTorch, the attention core in :func:`..ops.kernels.attn_fwd_core`) and
    :func:`reverse_pass` the JAX ``kstep`` reverse with the plain MLP arm and
    :func:`..ops.kernels.attn_rev_core`. Per block three anchors are saved
    (block input, post-attention midpoint, merged attention output).
  * ``matmul_precision`` ``"bfloat16"`` or ``"tensorfloat32"`` (the
    ``production`` and ``bfloat16`` presets): the whole-block megakernels,
    JAX ``step_fused_rich`` (:func:`..ops.kernels.block_fwd_core`, saving
    the rich anchors qkv_pre, proj_pre, dots, probs, fc1_pre, fc2_pre too)
    and ``kstep_block`` (:func:`..ops.kernels.block_rev_core` from the six
    saved anchors). The block weights are prepared once per model and mode
    (:meth:`VisionTransformer.block_params`).

In both, the class gradient and the LRP relevance advance together block by
block and each block yields its head-mean ``(grad ⊙ cam)⁺`` map; the
gradients are written by hand, autograd is not used. The embedding, the
final norm and the head stay exact products in the parameters' dtype.

The module holds parameters under timm's names (``blocks.{i}.attn.qkv``,
``blocks.{i}.mlp.fc1``, ...), so the state dicts of
``params.convert.vit_params_from_jax`` load as they are. Batch is the leading
dimension of every tensor. All products run in the parameters' dtype; in
float32 on a GPU they need TF32 off (checked by the explain entry points).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from transformer_explainability_torch.ops import kernels as K
from transformer_explainability_torch.ops import precision as prec
from transformer_explainability_torch.ops import relprop as rp
from transformer_explainability_torch.ops import block_math as bm
from transformer_explainability_torch.ops.block_math import BlockParams

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    # torch nn.LayerNorm defaults of the reference model: blocks use 1e-6,
    # the final norm the 1e-5 default
    block_ln_eps: float = 1e-6
    final_ln_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_prefix_tokens(self) -> int:
        return 1

    @property
    def num_tokens(self) -> int:
        return self.num_patches + self.num_prefix_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


VIT_BASE_16_224 = ViTConfig()


# ---------------------------------------------------------------------------
# Module (parameter container under timm names)
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, **kw):
        super().__init__()
        # applied as patchify + matmul (kernel == stride), never as a conv
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              cfg.patch_size, **kw)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, **kw):
        super().__init__()
        D = cfg.embed_dim
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias, **kw)
        self.proj = nn.Linear(D, D, **kw)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, **kw):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim, **kw)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim, **kw)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, **kw):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.block_ln_eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.block_ln_eps, **kw)
        self.mlp = Mlp(cfg, **kw)


class VisionTransformer(nn.Module):
    """ViT parameters in timm's layout; ``forward`` gives the logits."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, D, **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.final_ln_eps, **kw)
        self.head = nn.Linear(D, cfg.num_classes, **kw)

    @torch.no_grad()
    def forward(self, img: Tensor) -> Tensor:
        return forward_collect(self, img)[0]

    def block_params(self, i: int, mode: str) -> BlockParams:
        """Block ``i``'s parameters for the megakernels, its four weights
        prepared for ``mode`` (JAX ``prepare_block_weights``). The split is
        made once per model and mode and kept; it is made again only when a
        weight tensor is replaced or changed in place."""
        blk = self.blocks[i]
        lins = (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2)
        key = tuple((lin.weight.data_ptr(), lin.weight._version)
                    for lin in lins)
        cache = self.__dict__.setdefault("_prepared", {})
        if cache.get((i, mode), (None,))[0] != key:
            cache[(i, mode)] = (key, tuple(prec.prepare_weight(lin.weight,
                                                               mode)
                                           for lin in lins))
        qkv_bias = blk.attn.qkv.bias
        if qkv_bias is None:
            qkv_bias = torch.zeros(3 * self.cfg.embed_dim,
                                   dtype=blk.attn.proj.bias.dtype,
                                   device=blk.attn.proj.bias.device)
        return BlockParams(blk.norm1.weight, blk.norm1.bias, blk.norm2.weight,
                           blk.norm2.bias, qkv_bias, blk.attn.proj.bias,
                           blk.mlp.fc1.bias, blk.mlp.fc2.bias,
                           *cache[(i, mode)][1])


def init_params(cfg: ViTConfig, *, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Tensor]:
    """Random weights in timm's layout (JAX ``vit.init_params``):
    trunc-normal(std 0.02, cut at ±2σ) Linear/conv weights, CLS token and
    position embedding; zero biases; unit/zero LayerNorm. ``generator`` must
    live on ``device``; the same seed gives other numbers than JAX's
    ``PRNGKey``."""
    D, C, P = cfg.embed_dim, cfg.in_chans, cfg.patch_size
    kw = dict(device=device, dtype=dtype)

    def tn(*shape):
        return nn.init.trunc_normal_(torch.empty(*shape, **kw), std=0.02,
                                     a=-0.04, b=0.04, generator=generator)

    sd = {
        "patch_embed.proj.weight": tn(D, C, P, P),
        "patch_embed.proj.bias": torch.zeros(D, **kw),
        "cls_token": tn(1, 1, D),
        "pos_embed": tn(1, cfg.num_tokens, D),
    }
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        sd[p + "norm1.weight"] = torch.ones(D, **kw)
        sd[p + "norm1.bias"] = torch.zeros(D, **kw)
        sd[p + "attn.qkv.weight"] = tn(3 * D, D)
        if cfg.qkv_bias:
            sd[p + "attn.qkv.bias"] = torch.zeros(3 * D, **kw)
        sd[p + "attn.proj.weight"] = tn(D, D)
        sd[p + "attn.proj.bias"] = torch.zeros(D, **kw)
        sd[p + "norm2.weight"] = torch.ones(D, **kw)
        sd[p + "norm2.bias"] = torch.zeros(D, **kw)
        sd[p + "mlp.fc1.weight"] = tn(cfg.mlp_dim, D)
        sd[p + "mlp.fc1.bias"] = torch.zeros(cfg.mlp_dim, **kw)
        sd[p + "mlp.fc2.weight"] = tn(D, cfg.mlp_dim)
        sd[p + "mlp.fc2.bias"] = torch.zeros(D, **kw)
    sd["norm.weight"] = torch.ones(D, **kw)
    sd["norm.bias"] = torch.zeros(D, **kw)
    sd["head.weight"] = tn(cfg.num_classes, D)
    sd["head.bias"] = torch.zeros(cfg.num_classes, **kw)
    return sd


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layernorm(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """JAX ``vit._layernorm``: (x − μ) · rsqrt(var + eps) · γ + β."""
    return bm.ln_fwd(x, ln.weight, ln.bias, ln.eps)[0]


def _pre(x: Tensor, lin: nn.Linear) -> Tensor:
    """The pre-bias product ``x @ Wᵀ``. The bias is added apart, so that the
    forward and the reverse recompute form every activation with the same
    operations (the LRP rules need the forward's values bitwise)."""
    return x @ lin.weight.t()


def _bias(y: Tensor, lin: nn.Linear) -> Tensor:
    return y if lin.bias is None else y + lin.bias


class Residuals(NamedTuple):
    """What the reverse pass needs, collected by :func:`forward_collect`."""
    x0: Tensor              # tokens after the pos-embed add (B, n, D)
    cat_x: Tensor           # tokens before the pos-embed add (B, n, D)
    x_ins: List[Tensor]     # per block: input (B, n, D)
    x_mids: List[Tensor]    # per block: post-attention midpoint (B, n, D)
    outs: List[Tensor]      # per block: merged attention output (B, n, D)
    x_final: Tensor         # last block output (B, n, D)
    xn: Tensor              # final norm output (B, n, D)
    cls: Tensor             # pooled CLS (B, D), the head's input
    # rich anchors, per block (megakernel path only): pre-bias products and
    # the per-head attention dots (pre-scale) and probs, (B, h·n, n)
    qkv_pres: Optional[List[Tensor]] = None    # (B, n, 3D)
    proj_pres: Optional[List[Tensor]] = None   # (B, n, D)
    dots: Optional[List[Tensor]] = None
    probs: Optional[List[Tensor]] = None
    fc1_pres: Optional[List[Tensor]] = None    # (B, n, M)
    fc2_pres: Optional[List[Tensor]] = None    # (B, n, D)


def embed(model: VisionTransformer, img: Tensor) -> Tuple[Tensor, Tensor]:
    """Patchify-matmul embedding + CLS concat (JAX ``vit.embed``); returns
    ``(cat_x, x0)``. The patch product runs in the parameters' dtype at full
    precision (no TF32)."""
    cfg = model.cfg
    pe = model.patch_embed.proj
    patches = rp.patchify(img, cfg.patch_size)
    tok = patches @ pe.weight.reshape(cfg.embed_dim, -1).t() + pe.bias
    cls = model.cls_token.expand(img.shape[0], -1, -1)
    cat_x = torch.cat([cls, tok], dim=1)
    return cat_x, cat_x + model.pos_embed


def megakernel_base(matmul_precision: str) -> bool:
    """True if ``matmul_precision`` takes the block megakernels (JAX: the
    ``bfloat16`` / ``tensorfloat32`` bases of ``forward_collect`` and
    ``reverse_pass``)."""
    return matmul_precision in ("bfloat16", "tensorfloat32")


def forward_collect(model: VisionTransformer, img: Tensor,
                    ops: K.AttnOps = K.KERNEL_OPS,
                    matmul_precision: str = "float32",
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None
                    ) -> Tuple[Tensor, Residuals]:
    """Forward pass returning logits ``(B, num_classes)`` and the residuals
    (JAX ``vit.forward_collect``, ``use_attn_kernel=True``: the
    ``step_lite`` block at float32, the rich-anchor megakernel
    ``step_fused_rich`` at bfloat16 / tensorfloat32). ``img`` is
    ``(B, C, H, W)``."""
    cfg = model.cfg
    scale = cfg.head_dim ** -0.5
    cat_x, x0 = embed(model, img)
    if megakernel_base(matmul_precision):
        if prec.islands_exceed_base(matmul_precision, mlp_precision):
            raise NotImplementedError("an MLP precision above the base is "
                                      "not ported yet (ROADMAP A4)")
        return _forward_blocks(model, cat_x, x0, ops, matmul_precision,
                               prec.mxu_name(attn_precision, matmul_precision),
                               mlp_precision and prec.mxu_name(mlp_precision))
    x = x0
    x_ins, x_mids, outs = [], [], []
    for blk in model.blocks:
        qkv = _bias(_pre(_layernorm(x, blk.norm1), blk.attn.qkv), blk.attn.qkv)
        out_merged = ops.attn_fwd_core(qkv, cfg.num_heads, cfg.head_dim, scale)
        x_mid = x + _bias(_pre(out_merged, blk.attn.proj), blk.attn.proj)
        h1 = _bias(_pre(_layernorm(x_mid, blk.norm2), blk.mlp.fc1),
                   blk.mlp.fc1)
        hg = torch.nn.functional.gelu(h1, approximate="none")
        x_out = x_mid + _bias(_pre(hg, blk.mlp.fc2), blk.mlp.fc2)
        x_ins.append(x)
        x_mids.append(x_mid)
        outs.append(out_merged)
        x = x_out
    return _tail(model, x, Residuals(x0, cat_x, x_ins, x_mids, outs, x,
                                     None, None))


def _tail(model: VisionTransformer, x: Tensor, res: Residuals):
    """Final norm, CLS pool and head; fills ``x_final``, ``xn`` and ``cls``
    of ``res``."""
    xn = _layernorm(x, model.norm)
    cls = xn[:, 0]
    logits = _bias(_pre(cls, model.head), model.head)
    return logits, res._replace(x_final=x, xn=xn, cls=cls)


def _forward_blocks(model: VisionTransformer, cat_x: Tensor, x0: Tensor,
                    ops: K.AttnOps, mxu: str, attn_mxu: str,
                    mlp_mxu: Optional[str]) -> Tuple[Tensor, Residuals]:
    """The megakernel forward (JAX ``step_fused_rich`` with the MLP
    anchors): one ``block_fwd_core`` per block."""
    cfg = model.cfg
    x = x0
    keep = {k: [] for k in ("x_ins", "x_mids", "outs", "qkv_pres",
                            "proj_pres", "dots", "probs", "fc1_pres",
                            "fc2_pres")}
    for i in range(cfg.depth):
        outs = ops.block_fwd_core(
            x, model.block_params(i, mxu), cfg.num_heads, cfg.head_dim,
            cfg.block_ln_eps, mxu, attn_mxu, mlp_mxu, save_attn=True,
            save_mlp=True)
        keep["x_ins"].append(x)
        for k, t in zip(list(keep)[1:], outs[1:]):
            keep[k].append(t)
        x = outs[0]
    return _tail(model, x, Residuals(x0, cat_x, x_final=x, xn=None, cls=None,
                                     **keep))


# ---------------------------------------------------------------------------
# Reverse: hand-written gradients + LRP relevance, block by block
# ---------------------------------------------------------------------------

def _layernorm_bwd(g_y: Tensor, x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """Cotangent of LayerNorm w.r.t. its input (JAX ``vit._layernorm_bwd``)."""
    return bm.ln_bwd(g_y, x, *bm.ln_stats(x, ln.eps), ln.weight)


def reverse_pass(model: VisionTransformer, res: Residuals, onehot: Tensor,
                 alpha: float = 1.0, variant: str = "ours",
                 ops: K.AttnOps = K.KERNEL_OPS,
                 matmul_precision: str = "float32",
                 relprop_precision: Optional[str] = None,
                 attn_precision: Optional[str] = None,
                 mlp_precision: Optional[str] = None
                 ) -> Tuple[Tensor, Tensor]:
    """The fused gradient + relevance reverse pass (JAX ``vit.reverse_pass``
    with ``fuse_grad_cam=True, use_attn_kernel=True``: the plain MLP arm at
    float32, ``kstep_block`` at bfloat16 / tensorfloat32). Returns
    ``(R_tokens (B, n, D), gc (B, L, n, n))``: the relevance at the block-0
    input and, per block, the head-mean ``(grad ⊙ cam)⁺`` map."""
    cfg = model.cfg
    scale = cfg.head_dim ** -0.5
    head = model.head

    # gradient seed through head -> CLS pool -> final LayerNorm
    g_xn = torch.zeros_like(res.xn)
    g_xn[:, 0] = onehot @ head.weight
    g = _layernorm_bwd(g_xn, res.x_final, model.norm)

    # relevance seed: head rule, then the CLS index_select (the final norm
    # is an identity rule)
    R_cls = rp.linear_alphabeta(res.cls, head.weight.t(), onehot, alpha,
                                variant)
    R = rp.index_select_relprop(res.xn, 1, 0, R_cls[:, None, :])

    gcs = [None] * cfg.depth
    if megakernel_base(matmul_precision):
        if (prec.islands_exceed_base(matmul_precision, relprop_precision,
                                     mlp_precision)
                or variant != "ours" or alpha != 1.0):
            raise NotImplementedError("the block megakernels run variant "
                                      "'ours' at alpha 1 with islands at or "
                                      "below the base (ROADMAP A3, A4)")
        mxu = matmul_precision
        attn_mxu = prec.mxu_name(attn_precision, mxu)
        rule_mxu = prec.mxu_name(relprop_precision, mxu)
        mlp_mxu = mlp_precision and prec.mxu_name(mlp_precision)
        for li in reversed(range(cfg.depth)):
            saved = None
            if res.qkv_pres is not None:
                saved = (res.qkv_pres[li], res.proj_pres[li], res.dots[li],
                         res.probs[li], res.fc1_pres[li], res.fc2_pres[li])
            g, R, gcs[li] = ops.block_rev_core(
                res.x_ins[li], res.x_mids[li], res.outs[li], g, R,
                model.block_params(li, mxu), cfg.num_heads, cfg.head_dim,
                cfg.block_ln_eps, mxu, attn_mxu, rule_mxu, mlp_mxu, saved)
        return R, torch.stack(gcs, dim=1)

    for li in reversed(range(cfg.depth)):
        blk = model.blocks[li]
        x_in, x_mid, out_merged = res.x_ins[li], res.x_mids[li], res.outs[li]
        qkv_l, proj_l = blk.attn.qkv, blk.attn.proj
        fc1, fc2 = blk.mlp.fc1, blk.mlp.fc2

        # recompute (the same ops as the forward)
        xn1 = _layernorm(x_in, blk.norm1)
        qkv_pre = _pre(xn1, qkv_l)
        qkv = _bias(qkv_pre, qkv_l)
        proj_pre = _pre(out_merged, proj_l)
        attn_out = _bias(proj_pre, proj_l)
        xn2 = _layernorm(x_mid, blk.norm2)
        fc1_pre = _pre(xn2, fc1)
        h1 = _bias(fc1_pre, fc1)
        hg = torch.nn.functional.gelu(h1, approximate="none")
        fc2_pre = _pre(hg, fc2)
        mlp_out = _bias(fc2_pre, fc2)

        # backward, MLP half
        g_h1 = (g @ fc2.weight) * bm.gelu_grad(h1)
        g_mid = g + _layernorm_bwd(g_h1 @ fc1.weight, x_mid, blk.norm2)

        # relevance, MLP half: add2 split, fc2 and fc1 rules, clone
        R1, R2 = rp.add_relprop(x_mid, mlp_out, R, variant)
        R2 = rp.linear_alphabeta(hg, fc2.weight.t(), R2, alpha, variant,
                                 y_pre=fc2_pre)
        R2 = rp.linear_alphabeta(xn2, fc1.weight.t(), R2, alpha, variant,
                                 y_pre=fc1_pre)
        Rm = rp.clone_relprop(x_mid, [R1, R2])

        # attention half: add1 split and proj rule, then the fused core
        g_om = g_mid @ proj_l.weight
        Ra1, Ra2 = rp.add_relprop(x_in, attn_out, Rm, variant, Z=x_mid)
        cam_o = rp.linear_alphabeta(out_merged, proj_l.weight.t(), Ra2, alpha,
                                    variant, y_pre=proj_pre)
        g_qkv, cam_qkv, gcs[li] = ops.attn_rev_core(
            qkv, g_om, cam_o, cfg.num_heads, cfg.head_dim, scale)

        g = g_mid + _layernorm_bwd(g_qkv @ qkv_l.weight, x_in, blk.norm1)
        Rq = rp.linear_alphabeta(xn1, qkv_l.weight.t(), cam_qkv, alpha,
                                 variant, y_pre=qkv_pre)
        R = rp.clone_relprop(x_in, [Ra1, Rq])
    return R, torch.stack(gcs, dim=1)


__all__ = [
    "ViTConfig", "VIT_BASE_16_224", "VisionTransformer", "init_params",
    "Residuals", "embed", "megakernel_base", "forward_collect",
    "reverse_pass",
]
