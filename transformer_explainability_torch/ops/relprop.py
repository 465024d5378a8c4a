"""LRP relevance-propagation rules as plain functions on tensors.

Port of ``transformer_explainability_tpu/ops/relprop.py`` (each function
names its counterpart). The JAX rules are per example and batch through
``vmap``; here the batch is a leading dimension that the code writes out:

  * rules that act row by row (``safe_divide``, ``clone_relprop``,
    ``linear_alphabeta``, the bilinear and elementwise z-rules,
    ``add_eye_relprop``, ``compute_rollout``) take any leading dimensions;
  * ``zrule`` applies ``f`` to the batched inputs, so ``f`` must treat the
    samples apart, as JAX's ``vmap`` of it does;
  * ``cat_relprop``'s axis counts the batch dimension;
  * ``add_relprop`` renormalises with sums over one sample, so its tensors
    are ``(B, ...)`` and every sum runs over all dimensions but the first;
  * ``patchify``, ``unpatchify``, ``batchnorm2d_relprop`` and the patch
    conv rules take ``(B, C, H, W)`` images (the pixel bounds are per
    sample).

Identity-rule ops (softmax, LayerNorm, GELU) need no function. The rules
with products take a product ``mode`` (:func:`..ops.precision.product`):
the JAX rules follow the ambient ``default_matmul_precision``, which the
explain programs set to the rule island's; the default is exact.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from transformer_explainability_torch.ops.precision import product

EPS = 1e-9

Tensor = torch.Tensor


def safe_divide(a: Tensor, b: Tensor) -> Tensor:
    """Stabilised ``a / b`` (JAX ``relprop.safe_divide``): the denominator is
    ``b + eps``, nudged to ``eps`` where that sum is exactly zero, and the
    result is 0 wherever ``b == 0``."""
    den = b + EPS
    den = torch.where(den == 0, torch.full_like(den, EPS), den)
    return torch.where(b == 0, torch.zeros_like(a), a / den)


def zrule(f: Callable, inputs: Sequence[Tensor], R: Tensor):
    """Generic z-rule (JAX ``relprop.zrule``): ``Z = f(*inputs)``,
    ``S = R / Z``, ``C`` the VJP of ``f`` at ``S``, ``R_i = x_i * C_i``.
    Returns one relevance per input (the tensor alone for one input). The
    VJP is ``torch.func.vjp``'s, so it also runs under ``torch.no_grad()``,
    where every explain entry point runs."""
    Z, vjp = torch.func.vjp(f, *inputs)
    C = vjp(safe_divide(R, Z))
    outs = tuple(x * c for x, c in zip(inputs, C))
    return outs if len(outs) > 1 else outs[0]


def _sample_sum(x: Tensor) -> Tensor:
    """Sum over every dimension but the leading batch one, kept broadcastable
    against ``x``."""
    return x.sum(dim=tuple(range(1, x.ndim)), keepdim=True)


def add_relprop(a: Tensor, b: Tensor, R: Tensor, variant: str = "ours",
                Z: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Relevance split across a two-way add (JAX ``relprop.add_relprop``).

    ``variant="ours"`` renormalises each branch to a share of the sample's
    ``R.sum()`` proportional to the |branch total|; ``"lrp"`` is the plain
    z-rule. ``Z`` may be passed when the caller holds ``a + b`` already.
    Tensors are ``(B, ...)``; the sums are per sample.
    """
    if Z is None:
        Z = a + b
    S = safe_divide(R, Z)
    Ca = a * S
    Cb = b * S
    if variant == "lrp":
        return Ca, Cb
    if variant != "ours":
        raise ValueError(f"unknown variant {variant!r}")
    a_sum = _sample_sum(Ca)
    b_sum = _sample_sum(Cb)
    r_sum = _sample_sum(R)
    tot = a_sum.abs() + b_sum.abs()
    a_fact = safe_divide(a_sum.abs(), tot) * r_sum
    b_fact = safe_divide(b_sum.abs(), tot) * r_sum
    Ca = Ca * safe_divide(a_fact, _sample_sum(Ca))
    Cb = Cb * safe_divide(b_fact, _sample_sum(Cb))
    return Ca, Cb


def add_eye_relprop(x: Tensor, R: Tensor) -> Tensor:
    """z-rule through ``x + I`` (JAX ``relprop.add_eye_relprop``); ``x`` is
    ``(..., n, n)``."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return x * safe_divide(R, x + eye)


def clone_relprop(x: Tensor, Rs: Sequence[Tensor]) -> Tensor:
    """Merge the relevances of a fanned-out tensor (JAX
    ``relprop.clone_relprop``): ``x * safe_divide(sum_i R_i, x)``."""
    total = Rs[0]
    for r in Rs[1:]:
        total = total + r
    return x * safe_divide(total, x)


def cat_relprop(xs: Sequence[Tensor], axis: int,
                R: Tensor) -> Tuple[Tensor, ...]:
    """Relevance of a concatenation split back to its parts (JAX
    ``relprop.cat_relprop``): the z-rule, whose VJP splits ``S`` at the
    parts' static sizes along ``axis``."""
    S = safe_divide(R, torch.cat(list(xs), dim=axis))
    parts = torch.split(S, [x.shape[axis] for x in xs], dim=axis)
    return tuple(x * s for x, s in zip(xs, parts))


def index_select_relprop(x: Tensor, axis: int,
                         indices: Union[int, Sequence[int], Tensor],
                         R: Tensor) -> Tensor:
    """z-rule through an ``index_select`` (JAX
    ``relprop.index_select_relprop``); used for CLS pooling. ``R`` keeps the
    selected axis (one entry per index); the VJP scatters ``S`` back."""
    idx = torch.as_tensor(indices, dtype=torch.long, device=x.device)
    idx = idx.reshape(-1)
    Z = torch.index_select(x, axis, idx)
    S = safe_divide(R, Z)
    C = torch.zeros_like(x).index_add_(axis, idx, S)
    return x * C


def einsum_qk_relprop(q: Tensor, k: Tensor, R: Tensor,
                      mode: str = "float32") -> Tuple[Tensor, Tensor]:
    """z-rule through ``A = Q Kᵀ`` (JAX ``relprop.einsum_qk_relprop``);
    q, k are ``(..., i, d)``, R is ``(..., i, j)``."""
    Z = product(q, k.transpose(-1, -2), mode)
    S = safe_divide(R, Z)
    Cq = product(S, k, mode)
    Ck = product(S.transpose(-1, -2), q, mode)
    return q * Cq, k * Ck


def einsum_av_relprop(attn: Tensor, v: Tensor, R: Tensor,
                      mode: str = "float32") -> Tuple[Tensor, Tensor]:
    """z-rule through ``out = A V`` (JAX ``relprop.einsum_av_relprop``);
    attn is ``(..., i, j)``, v ``(..., j, d)``, R ``(..., i, d)``."""
    Z = product(attn, v, mode)
    S = safe_divide(R, Z)
    Ca = product(S, v.transpose(-1, -2), mode)
    Cv = product(attn.transpose(-1, -2), S, mode)
    return attn * Ca, v * Cv


def matmul_relprop(a: Tensor, b: Tensor, R: Tensor,
                   mode: str = "float32") -> Tuple[Tensor, Tensor]:
    """z-rule through a batched matmul ``(..., i, k) @ (..., k, j)`` (JAX
    ``relprop.matmul_relprop``)."""
    S = safe_divide(R, product(a, b, mode))
    return (a * product(S, b.transpose(-1, -2), mode),
            b * product(a.transpose(-1, -2), S, mode))


def mul_relprop(a: Tensor, b: Tensor, R: Tensor) -> Tuple[Tensor, Tensor]:
    """z-rule through an elementwise product (JAX ``relprop.mul_relprop``;
    BERT's head-mask split)."""
    S = safe_divide(R, a * b)
    return a * (S * b), b * (S * a)


def linear_alphabeta(x: Tensor, w: Tensor, R: Tensor, alpha: float = 1.0,
                     variant: str = "ours",
                     y_pre: Optional[Tensor] = None,
                     mode: str = "float32") -> Tensor:
    """α-β LRP rule for ``y = x @ w`` (JAX ``relprop.linear_alphabeta``).

    ``w`` is ``(in, out)`` as in the JAX package (pass ``weight.t()`` of an
    ``nn.Linear``); the bias is ignored by the rule. ``variant="ours"`` uses
    the shared ε-stabilised denominator written with the abs identity
    ``Z1+Z2 = (x@w + |x|@|w|) / 2``; ``y_pre = x @ w``, when the caller has
    it, saves one product. ``variant="lrp"`` uses separate denominators.
    """
    beta = alpha - 1.0

    def mm(a, b):
        return product(a, b, mode)

    if variant == "ours":
        ax = x.abs()
        aw = w.abs()
        xw = mm(x, w) if y_pre is None else y_pre
        axw = mm(ax, aw)
        Z = 0.5 * (xw + axw)
        S = safe_divide(R, Z)
        act = 0.5 * (x * mm(S, w.t()) + ax * mm(S, aw.t()))
        if beta == 0.0:
            return alpha * act
        Zi = 0.5 * (xw - axw)
        Si = safe_divide(R, Zi)
        inh = 0.5 * (x * mm(Si, w.t()) - ax * mm(Si, aw.t()))
        return alpha * act - beta * inh
    if variant != "lrp":
        raise ValueError(f"unknown variant {variant!r}")

    pw = w.clamp(min=0.0)
    nw = w.clamp(max=0.0)
    px = x.clamp(min=0.0)
    nx = x.clamp(max=0.0)

    def f(w1, w2, x1, x2):
        S1 = safe_divide(R, mm(x1, w1))
        S2 = safe_divide(R, mm(x2, w2))
        return x1 * mm(S1, w1.t()) + x2 * mm(S2, w2.t())

    activator = f(pw, nw, px, nx)
    if beta == 0.0:
        return alpha * activator
    inhibitor = f(nw, pw, px, nx)
    return alpha * activator - beta * inhibitor


def batchnorm2d_relprop(x: Tensor, weight: Tensor, running_var: Tensor,
                        R: Tensor, eps: float = 1e-5) -> Tensor:
    """Analytic BatchNorm rule (JAX ``relprop.batchnorm2d_relprop``):
    ``R_in = x · s · safe_divide(R, x · s)`` with ``s = w / sqrt(var + eps)``
    per channel; ``x`` and ``R`` are ``(B, C, H, W)``, ``weight`` and
    ``running_var`` ``(C,)``."""
    scale = (weight / torch.sqrt(running_var + eps))[:, None, None]
    return x * scale * safe_divide(R, x * scale)


def patchify(img: Tensor, patch: int) -> Tensor:
    """``(B, C, H, W) -> (B, num_patches, C*patch*patch)`` in the
    channel-major order of a Conv2d weight reshape (JAX
    ``relprop.patchify``)."""
    b, c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)                 # b, gh, gw, c, ph, pw
    return x.reshape(b, gh * gw, c * patch * patch)


def unpatchify(x: Tensor, patch: int, c: int, h: int, w: int) -> Tensor:
    """``(B, num_patches, C*patch*patch) -> (B, C, H, W)``, the inverse of
    :func:`patchify` (JAX ``relprop.unpatchify``)."""
    b = x.shape[0]
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, gw, c, patch, patch)
    x = x.permute(0, 3, 1, 4, 2, 5)                 # b, c, gh, ph, gw, pw
    return x.reshape(b, c, h, w)


def conv_patch_zB_relprop(img: Tensor, w: Tensor, R: Tensor,
                          patch: int, mode: str = "float32") -> Tensor:
    """z^B rule through the patch-embedding conv down to pixels bounded by
    each image's own min and max (JAX ``relprop.conv_patch_zB_relprop``).
    ``img (B, C, H, W)``; ``w (C*patch*patch, D)`` in the :func:`patchify`
    layout; ``R (B, num_patches, D)``. The division is plain, as the
    reference's. Returns the pixel relevance ``(B, C, H, W)``."""
    b, c, h, wd = img.shape
    flat = img.reshape(b, -1)
    lo = flat.min(dim=1).values[:, None, None]
    hi = flat.max(dim=1).values[:, None, None]
    pw = w.clamp(min=0.0)
    nw = w.clamp(max=0.0)
    X = patchify(img, patch)
    L = lo.expand_as(X)
    H = hi.expand_as(X)
    def mm(a, b):
        return product(a, b, mode)

    Za = mm(X, w) - mm(L, pw) - mm(H, nw) + EPS
    S = R / Za
    C = X * mm(S, w.t()) - L * mm(S, pw.t()) - H * mm(S, nw.t())
    return unpatchify(C, patch, c, h, wd)


def conv_patch_alphabeta_relprop(img: Tensor, w: Tensor, R: Tensor,
                                 patch: int, alpha: float = 1.0) -> Tensor:
    """α-β rule through the patch-embedding conv for a layer that is not
    the input (JAX ``relprop.conv_patch_alphabeta_relprop``), with the
    reference's separate denominators (even in the ``ours`` library).
    Shapes as :func:`conv_patch_zB_relprop`."""
    beta = alpha - 1.0
    b, c, h, wd = img.shape
    X = patchify(img, patch)
    pw = w.clamp(min=0.0)
    nw = w.clamp(max=0.0)
    px = X.clamp(min=0.0)
    nx = X.clamp(max=0.0)

    def f(w1, w2, x1, x2):
        S1 = safe_divide(R, x1 @ w1)
        S2 = safe_divide(R, x2 @ w2)
        return x1 * (S1 @ w1.t()) + x2 * (S2 @ w2.t())

    out = alpha * f(pw, nw, px, nx)
    if beta != 0.0:
        out = out - beta * f(nw, pw, px, nx)
    return unpatchify(out, patch, c, h, wd)


def compute_rollout(cams: Tensor, start_layer: int = 0,
                    row_normalize: bool = False,
                    mode: str = "float32") -> Tensor:
    """Rollout chain ``Π_{i=L-1..start} (cams_i + I)`` (JAX
    ``relprop.compute_rollout``); cams is ``(..., L, n, n)``."""
    L, n = cams.shape[-3], cams.shape[-1]
    eye = torch.eye(n, dtype=cams.dtype, device=cams.device)
    mats = cams + eye
    if row_normalize:
        mats = mats / mats.sum(dim=-1, keepdim=True)
    joint = mats[..., start_layer, :, :]
    for i in range(start_layer + 1, L):
        joint = product(mats[..., i, :, :], joint, mode)
    return joint


__all__ = [
    "EPS", "safe_divide", "zrule", "add_relprop", "add_eye_relprop",
    "clone_relprop", "cat_relprop", "index_select_relprop",
    "einsum_qk_relprop", "einsum_av_relprop", "matmul_relprop",
    "mul_relprop", "linear_alphabeta", "batchnorm2d_relprop", "patchify",
    "unpatchify", "conv_patch_zB_relprop", "conv_patch_alphabeta_relprop",
    "compute_rollout",
]
