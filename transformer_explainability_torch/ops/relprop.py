"""LRP relevance-propagation rules as plain functions on tensors.

Port of ``transformer_explainability_tpu/ops/relprop.py`` (each function
names its counterpart). The JAX rules are per example and batch through
``vmap``; here the batch is a leading dimension that the code writes out:

  * rules that act row by row (``safe_divide``, ``clone_relprop``,
    ``linear_alphabeta``, the bilinear z-rules, ``compute_rollout``) take any
    leading dimensions;
  * ``add_relprop`` renormalises with sums over one sample, so its tensors
    are ``(B, ...)`` and every sum runs over all dimensions but the first;
  * ``patchify`` takes ``(B, C, H, W)``.

Identity-rule ops (softmax, LayerNorm, GELU) need no function.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

EPS = 1e-9

Tensor = torch.Tensor


def safe_divide(a: Tensor, b: Tensor) -> Tensor:
    """Stabilised ``a / b`` (JAX ``relprop.safe_divide``): the denominator is
    ``b + eps``, nudged to ``eps`` where that sum is exactly zero, and the
    result is 0 wherever ``b == 0``."""
    den = b + EPS
    den = torch.where(den == 0, torch.full_like(den, EPS), den)
    return torch.where(b == 0, torch.zeros_like(a), a / den)


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


def clone_relprop(x: Tensor, Rs: Sequence[Tensor]) -> Tensor:
    """Merge the relevances of a fanned-out tensor (JAX
    ``relprop.clone_relprop``): ``x * safe_divide(sum_i R_i, x)``."""
    total = Rs[0]
    for r in Rs[1:]:
        total = total + r
    return x * safe_divide(total, x)


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


def einsum_qk_relprop(q: Tensor, k: Tensor, R: Tensor) -> Tuple[Tensor, Tensor]:
    """z-rule through ``A = Q Kᵀ`` (JAX ``relprop.einsum_qk_relprop``);
    q, k are ``(..., i, d)``, R is ``(..., i, j)``."""
    Z = q @ k.transpose(-1, -2)
    S = safe_divide(R, Z)
    Cq = S @ k
    Ck = S.transpose(-1, -2) @ q
    return q * Cq, k * Ck


def einsum_av_relprop(attn: Tensor, v: Tensor,
                      R: Tensor) -> Tuple[Tensor, Tensor]:
    """z-rule through ``out = A V`` (JAX ``relprop.einsum_av_relprop``);
    attn is ``(..., i, j)``, v ``(..., j, d)``, R ``(..., i, d)``."""
    Z = attn @ v
    S = safe_divide(R, Z)
    Ca = S @ v.transpose(-1, -2)
    Cv = attn.transpose(-1, -2) @ S
    return attn * Ca, v * Cv


def linear_alphabeta(x: Tensor, w: Tensor, R: Tensor, alpha: float = 1.0,
                     variant: str = "ours",
                     y_pre: Optional[Tensor] = None) -> Tensor:
    """α-β LRP rule for ``y = x @ w`` (JAX ``relprop.linear_alphabeta``).

    ``w`` is ``(in, out)`` as in the JAX package (pass ``weight.t()`` of an
    ``nn.Linear``); the bias is ignored by the rule. ``variant="ours"`` uses
    the shared ε-stabilised denominator written with the abs identity
    ``Z1+Z2 = (x@w + |x|@|w|) / 2``; ``y_pre = x @ w``, when the caller has
    it, saves one product. ``variant="lrp"`` uses separate denominators.
    """
    beta = alpha - 1.0
    if variant == "ours":
        ax = x.abs()
        aw = w.abs()
        xw = x @ w if y_pre is None else y_pre
        axw = ax @ aw
        Z = 0.5 * (xw + axw)
        S = safe_divide(R, Z)
        act = 0.5 * (x * (S @ w.t()) + ax * (S @ aw.t()))
        if beta == 0.0:
            return alpha * act
        Zi = 0.5 * (xw - axw)
        Si = safe_divide(R, Zi)
        inh = 0.5 * (x * (Si @ w.t()) - ax * (Si @ aw.t()))
        return alpha * act - beta * inh
    if variant != "lrp":
        raise ValueError(f"unknown variant {variant!r}")

    pw = w.clamp(min=0.0)
    nw = w.clamp(max=0.0)
    px = x.clamp(min=0.0)
    nx = x.clamp(max=0.0)

    def f(w1, w2, x1, x2):
        S1 = safe_divide(R, x1 @ w1)
        S2 = safe_divide(R, x2 @ w2)
        return x1 * (S1 @ w1.t()) + x2 * (S2 @ w2.t())

    activator = f(pw, nw, px, nx)
    if beta == 0.0:
        return alpha * activator
    inhibitor = f(nw, pw, px, nx)
    return alpha * activator - beta * inhibitor


def patchify(img: Tensor, patch: int) -> Tensor:
    """``(B, C, H, W) -> (B, num_patches, C*patch*patch)`` in the
    channel-major order of a Conv2d weight reshape (JAX
    ``relprop.patchify``)."""
    b, c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)                 # b, gh, gw, c, ph, pw
    return x.reshape(b, gh * gw, c * patch * patch)


def compute_rollout(cams: Tensor, start_layer: int = 0,
                    row_normalize: bool = False) -> Tensor:
    """Rollout chain ``Π_{i=L-1..start} (cams_i + I)`` (JAX
    ``relprop.compute_rollout``); cams is ``(..., L, n, n)``."""
    L, n = cams.shape[-3], cams.shape[-1]
    eye = torch.eye(n, dtype=cams.dtype, device=cams.device)
    mats = cams + eye
    if row_normalize:
        mats = mats / mats.sum(dim=-1, keepdim=True)
    joint = mats[..., start_layer, :, :]
    for i in range(start_layer + 1, L):
        joint = mats[..., i, :, :] @ joint
    return joint


__all__ = [
    "EPS", "safe_divide", "add_relprop", "clone_relprop",
    "index_select_relprop", "einsum_qk_relprop", "einsum_av_relprop",
    "linear_alphabeta", "patchify", "compute_rollout",
]
