"""Explainable Vision Transformer in PyTorch.

Port of ``transformer_explainability_tpu/models/vit.py``: the forward that
collects what the reverse needs, and the reverse pass in which the class
gradient and the LRP relevance advance together block by block. Its
branches are JAX's:

  * the kernel branch (``use_attn_kernel=True``; the generator takes it for
    ``transformer_attribution`` with variant ``ours`` at α=1), three anchors
    per block (block input, post-attention midpoint, merged attention
    output), each block yielding its head-mean ``(grad ⊙ cam)⁺`` map:

    - ``matmul_precision="float32"`` (exact FP32): the JAX ``step_lite``
      forward (LayerNorm and the Linear products in PyTorch, the attention
      core in :func:`..ops.kernels.attn_fwd_core`) and the ``kstep`` reverse
      with the plain MLP arm and :func:`..ops.kernels.attn_rev_core`;
    - ``"bfloat16"`` / ``"tensorfloat32"`` (the ``production`` and
      ``bfloat16`` presets): the whole-block megakernels, JAX
      ``step_fused_rich`` (:func:`..ops.kernels.block_fwd_core`, saving the
      rich anchors qkv_pre, proj_pre, dots, probs, fc1_pre, fc2_pre too) and
      ``kstep_block`` (:func:`..ops.kernels.block_rev_core`);
    - ``"bfloat16"`` with ``block_kernel=False`` (the split path, JAX's
      ``TE_TPU_NO_BLOCK_KERNEL=1``): ``step_lite`` and ``kstep`` with every
      product outside the kernels in bf16 (:func:`..ops.precision.kdot`, JAX's
      ambient ``default_matmul_precision``), the attention kernels in their
      bf16 modes and :func:`..ops.kernels.mlp_rev_core` for the MLP half;
    - ``"tensorfloat32"`` with ``block_kernel=False`` (the tf32 split arm):
      ``step_lite`` and ``kstep`` with every product outside the kernels in
      bf16×3, the attention kernels in the attention and rule islands'
      modes and the plain MLP arm at the base, its rules in the rule mode
      (JAX's MLP kernel runs the bfloat16 split path only);
    - ``"float32"`` with precision islands (the ``attn_precision`` and
      ``relprop_precision`` of JAX's kernel branch on its float32 base):
      ``step_lite`` and ``kstep`` as at float32, the attention kernels in
      the islands' modes, the rules outside them in the rule mode;

  * the non-kernel branch (``use_attn_kernel=False``; every other method,
    variant ``lrp`` and α ≠ 1, and any island above the base): the
    forward keeps the block inputs, midpoints and post-softmax attention
    maps; the reverse recomputes each block's activations
    (:func:`_block_acts_from_anchors`) and runs :func:`block_backward` and
    :func:`block_relprop` on them, fused or not. Its products run in the
    modes of a :class:`..ops.precision.Policy`, as JAX's lowered program
    runs them: the attention products (the scores, P·V and their backward)
    in the attention island's mode, the rules' products in the rule
    island's, every other product at the base; the MLP islands do not
    reach this branch (JAX's non-kernel blocks take no MLP precision).

The gradients are written by hand, autograd is not used; only
:func:`train_forward`, the plain forward of training (JAX ``vit.forward``
under the trainer's matmul precision), runs under autograd. The patch
embedding stays an exact product in the parameters' dtype, as JAX pins it;
the head runs at the base on the non-kernel branch and exact on the kernel
branch.

The configurations are ViT-B/16, ViT-L/16, DeiT-base and DeiT-base
distilled (``ViTConfig.distilled``: timm's DIST token after CLS and a second
head on its row, the logits ``(head(cls) + head_dist(dist)) / 2``, which
both seeds of the reverse follow). The module holds parameters under timm's
names (``blocks.{i}.attn.qkv``, ``blocks.{i}.mlp.fc1``, ``dist_token``,
``head_dist``, ...), so the state dicts of
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
from transformer_explainability_torch.ops.precision import transpose

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
    # DeiT's distillation token (timm ``deit_base_distilled_*``): a DIST
    # token after CLS and a second head on its row; the logits are
    # (head(cls) + head_dist(dist)) / 2, timm's eval fusion
    distilled: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

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
VIT_LARGE_16_224 = ViTConfig(embed_dim=1024, depth=24, num_heads=16)
# DeiT-base has ViT-B's architecture (the reference loads its checkpoint
# into the plain ViT); the distilled one adds the DIST token and its head
DEIT_BASE_16_224 = ViTConfig()
DEIT_BASE_DISTILLED_16_224 = ViTConfig(distilled=True)


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
        if cfg.distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, D, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, D, **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.final_ln_eps, **kw)
        self.head = nn.Linear(D, cfg.num_classes, **kw)
        if cfg.distilled:
            self.head_dist = nn.Linear(D, cfg.num_classes, **kw)

    @torch.no_grad()
    def forward(self, img: Tensor) -> Tensor:
        return forward_collect(self, img)[0]

    def block_params(self, i: int, mode: str) -> BlockParams:
        """Block ``i``'s parameters for the block kernels and the products
        of ``mode``, its four weights prepared for it (JAX
        ``prepare_block_weights``); ``"float32"`` takes the weights as they
        are. The split is made once per model and mode and kept; it is made
        again only when a weight tensor is replaced or changed in place."""
        blk = self.blocks[i]
        lins = (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2)
        key = tuple((lin.weight.data_ptr(), lin.weight._version)
                    for lin in lins)
        cache = self.__dict__.setdefault("_prepared", {})
        if mode == "float32":
            cache[(i, mode)] = (key, tuple(lin.weight for lin in lins))
        elif cache.get((i, mode), (None,))[0] != key:
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
    trunc-normal(std 0.02, cut at ±2σ) Linear/conv weights, CLS (and DIST)
    token and position embedding; zero biases; unit/zero LayerNorm. The
    numbers are drawn on ``generator``'s device and then moved to
    ``device``: pass a CPU generator, as
    :func:`..models.registry.create_model` does, and a seed is one model on
    every device (JAX pins ``init_params`` to the CPU for the same reason).
    The same seed gives other numbers than JAX's ``PRNGKey``."""
    D, C, P = cfg.embed_dim, cfg.in_chans, cfg.patch_size
    kw = dict(device=generator.device, dtype=dtype)

    def tn(*shape):
        return nn.init.trunc_normal_(torch.empty(*shape, **kw), std=0.02,
                                     a=-0.04, b=0.04, generator=generator)

    sd = {
        "patch_embed.proj.weight": tn(D, C, P, P),
        "patch_embed.proj.bias": torch.zeros(D, **kw),
        "cls_token": tn(1, 1, D),
        "pos_embed": tn(1, cfg.num_tokens, D),
    }
    if cfg.distilled:
        sd["dist_token"] = tn(1, 1, D)
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
    if cfg.distilled:
        sd["head_dist.weight"] = tn(cfg.num_classes, D)
        sd["head_dist.bias"] = torch.zeros(cfg.num_classes, **kw)
    return {k: v.to(device) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layernorm(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """JAX ``vit._layernorm``: (x − μ) · rsqrt(var + eps) · γ + β."""
    return bm.ln_fwd(x, ln.weight, ln.bias, ln.eps)[0]


def _pre(x: Tensor, lin: nn.Linear, mode: str = "float32") -> Tensor:
    """The pre-bias product ``x @ Wᵀ`` in product ``mode``. The bias is
    added apart, so that the forward and the reverse recompute form every
    activation with the same operations (the LRP rules need the forward's
    values bitwise)."""
    return prec.product(x, lin.weight.t(), mode)


def _bias(y: Tensor, lin: nn.Linear) -> Tensor:
    return y if lin.bias is None else y + lin.bias


class Residuals(NamedTuple):
    """What the reverse pass needs, collected by :func:`forward_collect`."""
    x0: Tensor              # tokens after the pos-embed add (B, n, D)
    cat_x: Tensor           # tokens before the pos-embed add (B, n, D)
    x_ins: List[Tensor]     # per block: input (B, n, D)
    x_mids: List[Tensor]    # per block: post-attention midpoint (B, n, D)
    # per block: merged attention output (B, n, D); kernel branch only
    outs: Optional[List[Tensor]]
    x_final: Tensor         # last block output (B, n, D)
    xn: Tensor              # final norm output (B, n, D)
    cls: Tensor             # pooled CLS (B, D), the head's input; a
    #                         distilled model's second head reads xn[:, 1]
    # rich anchors, per block (megakernel path only): pre-bias products and
    # the per-head attention dots (pre-scale) and probs, (B, h·n, n)
    qkv_pres: Optional[List[Tensor]] = None    # (B, n, 3D)
    proj_pres: Optional[List[Tensor]] = None   # (B, n, D)
    dots: Optional[List[Tensor]] = None
    probs: Optional[List[Tensor]] = None
    fc1_pres: Optional[List[Tensor]] = None    # (B, n, M)
    fc2_pres: Optional[List[Tensor]] = None    # (B, n, D)
    # post-softmax attention (B, L, h, n, n); non-kernel branch only
    attns: Optional[Tensor] = None


def embed(model: VisionTransformer, img: Tensor) -> Tuple[Tensor, Tensor]:
    """Patchify-matmul embedding + CLS (and DIST) concat (JAX
    ``vit.embed``); returns ``(cat_x, x0)``. The patch product runs in the
    parameters' dtype at full precision (no TF32)."""
    pe = model.patch_embed.proj
    return embed_tokens(model.cfg, pe.weight, pe.bias, model.cls_token,
                        model.pos_embed, img,
                        getattr(model, "dist_token", None))


def embed_tokens(cfg: ViTConfig, patch_weight: Tensor, patch_bias: Tensor,
                 cls_token: Tensor, pos_embed: Tensor, img: Tensor,
                 dist_token: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """:func:`embed` from the tensors themselves (the conv weight
    ``(D, C, P, P)``, its bias, the CLS token, the position embedding and,
    for a distilled config, the DIST token): CLS, then DIST, then the
    patches."""
    if cfg.distilled != (dist_token is not None):
        raise ValueError("a distilled config takes a DIST token, another "
                         "config none")
    patches = rp.patchify(img, cfg.patch_size)
    tok = prec.product(patches, patch_weight.reshape(cfg.embed_dim, -1).t(),
                       "float32") + patch_bias
    prefix = [cls_token] + ([dist_token] if cfg.distilled else [])
    cat_x = torch.cat([t.expand(img.shape[0], -1, -1) for t in prefix]
                      + [tok], dim=1)
    return cat_x, cat_x + pos_embed


def megakernel_base(matmul_precision: str) -> bool:
    """True if ``matmul_precision`` takes the block megakernels (JAX: the
    ``bfloat16`` / ``tensorfloat32`` bases of ``forward_collect`` and
    ``reverse_pass``)."""
    return matmul_precision in ("bfloat16", "tensorfloat32")


def _lite_mode(matmul_precision: str, block_kernel: bool,
               *islands: Optional[str]) -> Optional[str]:
    """The product mode of the ``step_lite`` / ``kstep`` blocks, or None
    where the kernel branch runs the megakernels: the base itself, float32
    or, without the megakernels (the split path), bfloat16 or
    tensorfloat32. Raises for a weight-consuming island above a reduced
    base, which JAX's generator sends down the non-kernel branch."""
    if not megakernel_base(matmul_precision):
        return "float32"
    if prec.islands_exceed_base(matmul_precision, *islands):
        raise ValueError(
            "an island above a reduced base runs on the non-kernel branch "
            "(use_attn_kernel=False), as JAX's generator sends it")
    return None if block_kernel else matmul_precision


def _lite_weights(mxu: str) -> str:
    """The weight preparation of the ``step_lite`` / ``kstep`` blocks in
    product mode ``mxu``: bf16 for the bfloat16 split path, whose MLP kernel
    B6 takes prepared weights; else the weights as they are, which the
    products outside the kernels split as they run (bitwise the prepared
    pairs; JAX's XLA arm takes the raw weights too)."""
    return "bfloat16" if mxu == "bfloat16" else "float32"


def forward_collect(model: VisionTransformer, img: Tensor,
                    ops: K.AttnOps = K.KERNEL_OPS,
                    matmul_precision: str = "float32",
                    attn_precision: Optional[str] = None,
                    mlp_precision: Optional[str] = None,
                    use_attn_kernel: bool = True,
                    block_kernel: bool = True
                    ) -> Tuple[Tensor, Residuals]:
    """Forward pass returning logits ``(B, num_classes)`` and the residuals
    (JAX ``vit.forward_collect``). ``img`` is ``(B, C, H, W)``. With
    ``use_attn_kernel``: the ``step_lite`` block at float32 and, with
    ``block_kernel=False``, at bfloat16 and tensorfloat32; the rich-anchor
    megakernel ``step_fused_rich`` at bfloat16 / tensorfloat32. Without:
    the plain blocks, keeping the post-softmax attention maps."""
    cfg = model.cfg
    cat_x, x0 = embed(model, img)
    if not use_attn_kernel:
        return _forward_acts(model, cat_x, x0, prec.Policy.resolve(
            matmul_precision, attn_precision))
    mxu = _lite_mode(matmul_precision, block_kernel, mlp_precision)
    attn_mxu = prec.mxu_name(attn_precision, matmul_precision)
    if mxu is None:
        return _forward_blocks(model, cat_x, x0, ops, matmul_precision,
                               attn_mxu,
                               mlp_precision and prec.mxu_name(mlp_precision))
    scale = cfg.head_dim ** -0.5
    x = x0
    x_ins, x_mids, outs = [], [], []
    for i, blk in enumerate(model.blocks):
        p = model.block_params(i, _lite_weights(mxu))
        qkv = (prec.product(_layernorm(x, blk.norm1), transpose(p.wqkv), mxu)
               + p.bqkv)
        out_merged = ops.attn_fwd_core(qkv, cfg.num_heads, cfg.head_dim,
                                       scale, mxu=attn_mxu)
        x_mid = x + (prec.product(out_merged, transpose(p.wproj), mxu)
                     + p.bproj)
        hg = bm.gelu_exact(prec.product(_layernorm(x_mid, blk.norm2),
                                        transpose(p.w1), mxu) + p.b1)
        x_out = x_mid + (prec.product(hg, transpose(p.w2), mxu) + p.b2)
        x_ins.append(x)
        x_mids.append(x_mid)
        outs.append(out_merged)
        x = x_out
    return _tail(model, x, Residuals(x0, cat_x, x_ins, x_mids, outs, x,
                                     None, None))


def _tail(model: VisionTransformer, x: Tensor, res: Residuals,
          mode: str = "float32"):
    """Final norm, CLS pool and head in product ``mode`` (a distilled
    model's two heads fused, ``(head(cls) + head_dist(dist)) / 2``); fills
    ``x_final``, ``xn`` and ``cls`` of ``res``. The non-kernel branch runs
    the head at its base, as JAX does; the kernel branch keeps it exact."""
    xn = _layernorm(x, model.norm)
    cls = xn[:, 0]
    logits = _bias(_pre(cls, model.head, mode), model.head)
    if model.cfg.distilled:
        hd = model.head_dist
        logits = (logits + _bias(_pre(xn[:, 1], hd, mode), hd)) / 2
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


class BlockActs(NamedTuple):
    """One block's activations in forward order (JAX ``vit.BlockActs``),
    batched."""
    xn1: Tensor         # norm1 output (B, n, D)
    qkv: Tensor         # qkv product incl. bias (B, n, 3D), 'n (qkv h d)'
    q: Tensor           # (B, h, n, hd)
    k: Tensor
    v: Tensor
    attn: Tensor        # post-softmax attention (B, h, n, n)
    out_merged: Tensor  # attention output, heads merged (B, n, D)
    attn_out: Tensor    # proj output (B, n, D), add1's second operand
    xn2: Tensor         # norm2 output (B, n, D)
    h1: Tensor          # fc1 output, pre-GELU (B, n, M)
    hg: Tensor          # GELU output (B, n, M)
    mlp_out: Tensor     # fc2 output (B, n, D), add2's second operand


def _block_acts(x_in: Tensor, blk: Block, cfg: ViTConfig,
                x_mid: Optional[Tensor] = None,
                pol: prec.Policy = prec.EXACT
                ) -> Tuple[Tensor, Tensor, BlockActs]:
    """One block from its input (JAX ``vit._block_acts``): the scores and
    P·V in ``pol.attn``, the Linear products at ``pol.base``; returns
    ``(x_mid, x_out, acts)``. A given ``x_mid`` anchor feeds the MLP half
    instead of the recomputed midpoint (JAX ``_block_acts_from_anchors``)."""
    qkv_l, proj = blk.attn.qkv, blk.attn.proj
    base = pol.base
    xn1 = _layernorm(x_in, blk.norm1)
    qkv = _bias(_pre(xn1, qkv_l, base), qkv_l)
    q, k, v = bm.split_heads(qkv, cfg.num_heads, cfg.head_dim)
    dots = prec.product(q, k.transpose(-1, -2), pol.attn)
    attn = torch.softmax(dots * cfg.head_dim ** -0.5, dim=-1)
    out_merged = bm.merge_heads(prec.product(attn, v, pol.attn))
    attn_out = _pre(out_merged, proj, base) + proj.bias
    if x_mid is None:
        x_mid = x_in + attn_out
    fc1, fc2 = blk.mlp.fc1, blk.mlp.fc2
    xn2 = _layernorm(x_mid, blk.norm2)
    h1 = _pre(xn2, fc1, base) + fc1.bias
    hg = bm.gelu_exact(h1)
    mlp_out = _pre(hg, fc2, base) + fc2.bias
    return x_mid, x_mid + mlp_out, BlockActs(
        xn1, qkv, q, k, v, attn, out_merged, attn_out, xn2, h1, hg, mlp_out)


def _block_acts_from_anchors(x_in: Tensor, x_mid: Tensor, blk: Block,
                             cfg: ViTConfig,
                             pol: prec.Policy = prec.EXACT) -> BlockActs:
    """Every activation of a block recomputed from its two anchors, each by
    the forward's own operations in the forward's modes (JAX
    ``vit._block_acts_from_anchors``)."""
    return _block_acts(x_in, blk, cfg, x_mid, pol)[2]


def _forward_acts(model: VisionTransformer, cat_x: Tensor, x0: Tensor,
                  pol: prec.Policy = prec.EXACT
                  ) -> Tuple[Tensor, Residuals]:
    """The non-kernel forward (JAX ``forward_collect``'s checkpointed
    ``step``): block inputs, midpoints and post-softmax attention maps."""
    x = x0
    x_ins, x_mids, attns = [], [], []
    for blk in model.blocks:
        x_mid, x_out, acts = _block_acts(x, blk, model.cfg, pol=pol)
        x_ins.append(x)
        x_mids.append(x_mid)
        attns.append(acts.attn)
        x = x_out
    return _tail(model, x, Residuals(x0, cat_x, x_ins, x_mids, None, x, None,
                                     None, attns=torch.stack(attns, dim=1)),
                 pol.base)


def train_forward(model: VisionTransformer, img: Tensor,
                  matmul_precision: str = "float32") -> Tensor:
    """The differentiable plain forward of training: the logits ``(B,
    classes)`` that JAX ``vit.forward`` computes under
    ``default_matmul_precision(matmul_precision)``, with autograd taking the
    gradients. Every product but the patch embedding (exact, as JAX pins
    it) runs in ``matmul_precision``'s product mode, forward and backward
    (:func:`..ops.precision.pmatmul`): ``"float32"`` exact FP32,
    ``"bfloat16"`` and ``"tensorfloat32"`` as :func:`..ops.precision.kdot`
    defines them. No kernel runs here; the explain path
    (:func:`forward_collect`) is untouched."""
    if matmul_precision not in prec.MODES:
        raise ValueError(f"unknown precision {matmul_precision!r}; "
                         f"available: {list(prec.MODES)}")
    cfg = model.cfg

    def mm(a, b):
        return prec.pmatmul(a, b, matmul_precision)

    def lin(x, layer):
        return _bias(mm(x, layer.weight.t()), layer)

    x = embed(model, img)[1]
    for blk in model.blocks:
        qkv = lin(_layernorm(x, blk.norm1), blk.attn.qkv)
        q, k, v = bm.split_heads(qkv, cfg.num_heads, cfg.head_dim)
        attn = torch.softmax(mm(q, k.transpose(-1, -2))
                             * cfg.head_dim ** -0.5, dim=-1)
        x = x + lin(bm.merge_heads(mm(attn, v)), blk.attn.proj)
        h1 = lin(_layernorm(x, blk.norm2), blk.mlp.fc1)
        x = x + lin(bm.gelu_exact(h1), blk.mlp.fc2)
    xn = _layernorm(x, model.norm)
    logits = lin(xn[:, 0], model.head)
    if cfg.distilled:
        logits = (logits + lin(xn[:, 1], model.head_dist)) / 2
    return logits


# ---------------------------------------------------------------------------
# Reverse: hand-written gradients + LRP relevance, block by block
# ---------------------------------------------------------------------------

def _layernorm_bwd(g_y: Tensor, x: Tensor, ln: nn.LayerNorm) -> Tensor:
    """Cotangent of LayerNorm w.r.t. its input (JAX ``vit._layernorm_bwd``)."""
    return bm.ln_bwd(g_y, x, *bm.ln_stats(x, ln.eps), ln.weight)


def block_backward(g_out: Tensor, x_in: Tensor, x_mid: Tensor,
                   acts: BlockActs, blk: Block, cfg: ViTConfig,
                   pol: prec.Policy = prec.EXACT
                   ) -> Tuple[Tensor, Tensor]:
    """Hand-written VJP of one block from its activations (JAX
    ``vit.block_backward``): ``(g_in, g_attn)``, ``g_attn (B, h, n, n)`` the
    cotangent of the post-softmax attention (the reference's
    ``register_hook`` gradient). The attention chain's products run in
    ``pol.attn``, the Linear gradients at ``pol.base``."""
    h, hd = cfg.num_heads, cfg.head_dim
    base, ap = pol.base, pol.attn

    def mm(a, b, mode):
        return prec.product(a, b, mode)

    g_h1 = mm(g_out, blk.mlp.fc2.weight, base) * bm.gelu_grad(acts.h1)
    g_mid = g_out + _layernorm_bwd(mm(g_h1, blk.mlp.fc1.weight, base),
                                   x_mid, blk.norm2)
    g_o = bm.to_heads(mm(g_mid, blk.attn.proj.weight, base), h, hd)
    g_attn = mm(g_o, acts.v.transpose(-1, -2), ap)
    g_v = mm(acts.attn.transpose(-1, -2), g_o, ap)
    inner = (g_attn * acts.attn).sum(dim=-1, keepdim=True)
    g_dots = acts.attn * (g_attn - inner) * hd ** -0.5
    g_qkv = bm.merge3(mm(g_dots, acts.k, ap),
                      mm(g_dots.transpose(-1, -2), acts.q, ap), g_v)
    g_in = g_mid + _layernorm_bwd(mm(g_qkv, blk.attn.qkv.weight, base),
                                  x_in, blk.norm1)
    return g_in, g_attn


def block_relprop(R: Tensor, x_in: Tensor, x_mid: Tensor, blk: Block,
                  cfg: ViTConfig, alpha: float = 1.0, variant: str = "ours",
                  acts: Optional[BlockActs] = None,
                  pol: prec.Policy = prec.EXACT
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """LRP through one block in reverse order (JAX ``vit.block_relprop``):
    ``(R_in, attn_cam (B, h, n, n), v_cam (B, h, n, hd))``, every rule
    product in ``pol.rule``. The activations are recomputed from the two
    anchors unless ``acts`` is given, in the forward's modes (JAX
    recomputes them outside the rule context, so the rules' linearisation
    points are the forward's)."""
    if acts is None:
        acts = _block_acts_from_anchors(x_in, x_mid, blk, cfg, pol)
    rule = pol.rule
    qkv_l, proj = blk.attn.qkv, blk.attn.proj
    fc1, fc2 = blk.mlp.fc1, blk.mlp.fc2
    # the forward's pre-bias products from the activations, as JAX forms
    # them (the rules' y_pre)
    qkv_pre = acts.qkv if qkv_l.bias is None else acts.qkv - qkv_l.bias

    # add2 -> fc2 -> fc1 -> clone
    R1, R2 = rp.add_relprop(x_mid, acts.mlp_out, R, variant)
    R2 = rp.linear_alphabeta(acts.hg, fc2.weight.t(), R2, alpha, variant,
                             y_pre=acts.mlp_out - fc2.bias, mode=rule)
    R2 = rp.linear_alphabeta(acts.xn2, fc1.weight.t(), R2, alpha, variant,
                             y_pre=acts.h1 - fc1.bias, mode=rule)
    Rm = rp.clone_relprop(x_mid, [R1, R2])

    # add1 (Z = the stored x_mid) -> proj -> attention -> qkv -> clone
    R1, R2 = rp.add_relprop(x_in, acts.attn_out, Rm, variant, Z=x_mid)
    R2 = rp.linear_alphabeta(acts.out_merged, proj.weight.t(), R2, alpha,
                             variant, y_pre=acts.attn_out - proj.bias,
                             mode=rule)
    cam = bm.to_heads(R2, cfg.num_heads, cfg.head_dim)
    cam1, cam_v = rp.einsum_av_relprop(acts.attn, acts.v, cam, rule)
    cam1, cam_v = cam1 / 2, cam_v / 2
    cam_q, cam_k = rp.einsum_qk_relprop(acts.q, acts.k, cam1, rule)
    cam_qkv = bm.merge3(cam_q / 2, cam_k / 2, cam_v)
    R2 = rp.linear_alphabeta(acts.xn1, qkv_l.weight.t(), cam_qkv, alpha,
                             variant, y_pre=qkv_pre, mode=rule)
    return rp.clone_relprop(x_in, [R1, R2]), cam1, cam_v


def relprop(model: VisionTransformer, res: Residuals, R_logits: Tensor,
            alpha: float = 1.0, variant: str = "ours",
            matmul_precision: str = "float32",
            relprop_precision: Optional[str] = None,
            attn_precision: Optional[str] = None
            ) -> Tuple[Tensor, Tensor]:
    """Relevance from ``R_logits (B, num_classes)`` through the head, the
    pool, the final norm and the blocks (JAX ``vit.relprop``): the
    non-kernel reverse without gradients, at the base and islands JAX's
    ambient ``default_matmul_precision`` would give it (exact by default).
    Returns ``(R_tokens, attn_cams (B, L, h, n, n))``; ``res`` from the
    non-kernel forward."""
    R_tokens, attn_cams, _ = reverse_pass(
        model, res, R_logits, alpha, variant, need_grads=False,
        fuse_grad_cam=False, use_attn_kernel=False,
        matmul_precision=matmul_precision,
        relprop_precision=relprop_precision, attn_precision=attn_precision)
    return R_tokens, attn_cams


def _trunk_stats(g: Tensor, R: Tensor) -> Tensor:
    """The trunk statistics of one block's reverse step (JAX
    ``vit._trunk_stats``): ``(|g|_inf, |g|_1, |R|_inf, |R|_1)`` of the
    carries after the step, per sample, ``(B, 4)`` float32. PyTorch
    reductions on the tensors the loop carries anyway, outside every
    kernel, so the explanation does not change when they are taken."""
    ag, aR = g.abs().flatten(1), R.abs().flatten(1)
    return torch.stack([ag.amax(1), ag.sum(1), aR.amax(1), aR.sum(1)],
                       dim=1).float()


def _seeds(model: VisionTransformer, res: Residuals, onehot: Tensor,
           alpha: float, variant: str, need_grads: bool, need_relprop: bool,
           mode: str = "float32"
           ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """The reverse's seeds at the last block's output (JAX
    ``vit.reverse_pass``): the class gradient through the head(s), the
    pooled rows and the final LayerNorm, and the relevance through the head
    rule(s) and the pooling (the final norm is an identity rule), every
    product at the base ``mode`` (JAX forms the seeds outside the rule
    island). A distilled model's logits are ``(head(cls) + head_dist(dist)) / 2``: the
    gradient reaches rows 0 and 1, each ``onehot @ W / 2``; the relevance
    splits between the two heads by the add rule (the /2 is an identity
    rule) and each head's rule puts its share on its own row."""
    head = model.head
    g = R = None
    if need_grads:
        g_xn = torch.zeros_like(res.xn)
        if model.cfg.distilled:
            g_xn[:, 0] = prec.product(onehot, head.weight, mode) / 2
            g_xn[:, 1] = prec.product(onehot, model.head_dist.weight,
                                      mode) / 2
        else:
            g_xn[:, 0] = prec.product(onehot, head.weight, mode)
        g = _layernorm_bwd(g_xn, res.x_final, model.norm)
    if need_relprop:
        if model.cfg.distilled:
            hdist = model.head_dist
            x_cls, x_dist = res.xn[:, 0], res.xn[:, 1]
            R1, R2 = rp.add_relprop(_bias(_pre(x_cls, head, mode), head),
                                    _bias(_pre(x_dist, hdist, mode), hdist),
                                    onehot, variant)
            R = torch.zeros_like(res.xn)
            R[:, 0] = rp.linear_alphabeta(x_cls, head.weight.t(), R1, alpha,
                                          variant, mode=mode)
            R[:, 1] = rp.linear_alphabeta(x_dist, hdist.weight.t(), R2,
                                          alpha, variant, mode=mode)
        else:
            R_cls = rp.linear_alphabeta(res.cls, head.weight.t(), onehot,
                                        alpha, variant, mode=mode)
            R = rp.index_select_relprop(res.xn, 1, 0, R_cls[:, None, :])
    return g, R


def _fused_out(R: Tensor, gcs: List[Tensor], trunk: Optional[List[Tensor]]):
    """The fused reverse's result: ``(R_tokens, gc (B, L, n, n), None)``
    and, with trunk statistics, ``trunk (B, L, 4)`` as a fourth entry."""
    out = (R, torch.stack(gcs, dim=1), None)
    return out if trunk is None else out + (torch.stack(trunk, dim=1),)


def reverse_pass(model: VisionTransformer, res: Residuals, onehot: Tensor,
                 alpha: float = 1.0, variant: str = "ours",
                 ops: K.AttnOps = K.KERNEL_OPS,
                 matmul_precision: str = "float32",
                 relprop_precision: Optional[str] = None,
                 attn_precision: Optional[str] = None,
                 mlp_precision: Optional[str] = None,
                 need_grads: bool = True, need_relprop: bool = True,
                 fuse_grad_cam: bool = True, use_attn_kernel: bool = True,
                 block_kernel: bool = True, with_trunk_stats: bool = False
                 ) -> Tuple[Optional[Tensor], ...]:
    """The gradient + relevance reverse pass (JAX ``vit.reverse_pass``).

    With ``use_attn_kernel`` (``fuse_grad_cam`` and both passes, variant
    ``ours`` at α=1): ``kstep`` with the plain MLP arm at float32 and
    tensorfloat32, with ``mlp_rev_core`` at bfloat16 when ``block_kernel``
    is off, else
    ``kstep_block``. Without: the plain ``step`` over the recomputed
    activations, in the modes of the branch's policy (the seeds at the
    base, the attention chain in the attention island's mode, the rules in
    the rule island's). ``mlp_precision`` is the MLP's reverse-side
    products' (the generator's ``mlp_bwd_precision``) on the kernel
    branch; the non-kernel branch runs the MLP at the base, as JAX does.

    Returns ``(R_tokens (B, n, D), gc (B, L, n, n), None)`` with
    ``fuse_grad_cam``: the relevance at the block-0 input and, per block, the
    head-mean ``(grad ⊙ cam)⁺`` map; else ``(R_tokens, attn_cams,
    attn_grads)``, the last two ``(B, L, h, n, n)``, each None where its
    ``need_*`` flag is off. ``with_trunk_stats`` (``fuse_grad_cam`` only)
    appends ``trunk (B, L, 4)``, :func:`_trunk_stats` after each block's
    step."""
    cfg = model.cfg
    if fuse_grad_cam and not (need_grads and need_relprop):
        raise ValueError("fuse_grad_cam needs both passes")
    if with_trunk_stats and not fuse_grad_cam:
        raise ValueError("trunk stats are taken by the fused reverse only")
    trunk = [None] * cfg.depth if with_trunk_stats else None

    if not use_attn_kernel:
        pol = prec.Policy.resolve(matmul_precision, attn_precision,
                                  relprop_precision)
        g, R = _seeds(model, res, onehot, alpha, variant, need_grads,
                      need_relprop, pol.base)
        return _reverse_acts(model, res, g, R, alpha, variant, need_grads,
                             need_relprop, fuse_grad_cam, trunk, pol)
    if not (fuse_grad_cam and variant == "ours" and alpha == 1.0):
        raise NotImplementedError(
            "the kernel branch runs the fused method with variant 'ours' at "
            "alpha 1; the others take use_attn_kernel=False")
    g, R = _seeds(model, res, onehot, alpha, variant, need_grads,
                  need_relprop)
    gcs = [None] * cfg.depth
    mxu = _lite_mode(matmul_precision, block_kernel, relprop_precision,
                     mlp_precision)
    attn_mxu = prec.mxu_name(attn_precision, matmul_precision)
    rule_mxu = prec.mxu_name(relprop_precision, matmul_precision)
    if mxu is None:
        mxu = matmul_precision
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
            if trunk is not None:
                trunk[li] = _trunk_stats(g, R)
        return _fused_out(R, gcs, trunk)

    # kstep: the MLP half in mlp_rev_core on the bfloat16 split path, else
    # the plain arm; the add1 and proj rules, the attention core, the qkv
    # tails
    mlp_mxu = prec.mxu_name(mlp_precision, mxu)
    scale = cfg.head_dim ** -0.5
    for li in reversed(range(cfg.depth)):
        blk = model.blocks[li]
        p = model.block_params(li, _lite_weights(mxu))
        x_in, x_mid, out_merged = res.x_ins[li], res.x_mids[li], res.outs[li]

        # recompute (the same ops as the forward)
        xn1 = _layernorm(x_in, blk.norm1)
        qkv_pre = prec.product(xn1, transpose(p.wqkv), mxu)
        proj_pre = prec.product(out_merged, transpose(p.wproj), mxu)
        if mxu == "bfloat16":
            g_mid, Rm = ops.mlp_rev_core(x_mid, g, R, p, cfg.block_ln_eps,
                                         mlp_mxu, rule_mxu)
        else:
            # JAX's XLA MLP arm (its MLP kernel runs the bfloat16 split
            # path only): the products at the base, the rules in the rule
            # mode (JAX with_rule_precision)
            g_mid, Rm = bm.mlp_rev_math(x_mid, g, R, p, eps=cfg.block_ln_eps,
                                        mxu=mxu, rule_mxu=rule_mxu)

        g_om = prec.product(g_mid, p.wproj, mxu)
        Ra1, Ra2 = rp.add_relprop(x_in, proj_pre + p.bproj, Rm, Z=x_mid)
        cam_o = bm.linear_rule_math(out_merged, p.wproj, Ra2, proj_pre,
                                    rule_mxu)
        g_qkv, cam_qkv, gcs[li] = ops.attn_rev_core(
            qkv_pre + p.bqkv, g_om, cam_o, cfg.num_heads, cfg.head_dim,
            scale, attn_mxu=attn_mxu, rule_mxu=rule_mxu)

        g = g_mid + _layernorm_bwd(prec.product(g_qkv, p.wqkv, mxu), x_in,
                                   blk.norm1)
        Rq = bm.linear_rule_math(xn1, p.wqkv, cam_qkv, qkv_pre, rule_mxu)
        R = rp.clone_relprop(x_in, [Ra1, Rq])
        if trunk is not None:
            trunk[li] = _trunk_stats(g, R)
    return _fused_out(R, gcs, trunk)


def _reverse_acts(model: VisionTransformer, res: Residuals,
                  g: Optional[Tensor], R: Optional[Tensor], alpha: float,
                  variant: str, need_grads: bool, need_relprop: bool,
                  fuse_grad_cam: bool, trunk: Optional[List[Tensor]] = None,
                  pol: prec.Policy = prec.EXACT):
    """The non-kernel reverse (JAX ``reverse_pass``'s plain ``step``) in
    the modes of ``pol``; ``trunk`` (a list of L, fused only) receives each
    step's :func:`_trunk_stats`."""
    cfg = model.cfg
    cams, grads = [None] * cfg.depth, [None] * cfg.depth
    for li in reversed(range(cfg.depth)):
        blk, x_in, x_mid = model.blocks[li], res.x_ins[li], res.x_mids[li]
        acts = _block_acts_from_anchors(x_in, x_mid, blk, cfg, pol)
        if need_grads:
            g, grads[li] = block_backward(g, x_in, x_mid, acts, blk, cfg,
                                          pol)
        if need_relprop:
            R, cams[li], _ = block_relprop(R, x_in, x_mid, blk, cfg, alpha,
                                           variant, acts, pol)
        if fuse_grad_cam:
            cams[li] = (grads[li] * cams[li]).clamp(min=0).mean(dim=1)
            if trunk is not None:
                trunk[li] = _trunk_stats(g, R)
    if fuse_grad_cam:
        return _fused_out(R, cams, trunk)
    return (R, torch.stack(cams, dim=1) if need_relprop else None,
            torch.stack(grads, dim=1) if need_grads else None)


def full_lrp_input_relevance(model: VisionTransformer, res: Residuals,
                             R_tokens: Tensor, img: Tensor,
                             variant: str = "ours",
                             matmul_precision: str = "float32") -> Tensor:
    """Relevance continued to the pixels (JAX
    ``vit.full_lrp_input_relevance``, method ``full``): the pos-embed add,
    the CLS (and DIST) rows dropped, the patch conv's z^B rule with its
    products at the base, the channel sum.
    Returns ``(B, H, W)``."""
    cfg = model.cfg
    Rx, _ = rp.add_relprop(res.cat_x, model.pos_embed.expand_as(res.cat_x),
                           R_tokens, variant)
    w = model.patch_embed.proj.weight.reshape(cfg.embed_dim, -1).t()
    cam = rp.conv_patch_zB_relprop(img, w, Rx[:, cfg.num_prefix_tokens:],
                                   cfg.patch_size,
                                   prec.mxu_name(matmul_precision))
    return cam.sum(dim=1)


__all__ = [
    "ViTConfig", "VIT_BASE_16_224", "VIT_LARGE_16_224", "DEIT_BASE_16_224",
    "DEIT_BASE_DISTILLED_16_224", "VisionTransformer", "init_params",
    "Residuals", "BlockActs", "embed", "megakernel_base", "forward_collect",
    "block_backward", "block_relprop", "relprop", "reverse_pass",
    "full_lrp_input_relevance",
]
