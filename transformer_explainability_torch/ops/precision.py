"""Per-product precision modes of the block kernels, as plain PyTorch.

Port of the precision helpers of
``transformer_explainability_tpu/ops/pallas_kernels.py`` (each function
names its counterpart). A product runs in one of three modes:

  * ``"bfloat16"``: both operands rounded to bf16 (round to nearest even),
    products and sums in float32 (float64 for float64 operands);
  * ``"tensorfloat32"``: the bf16×3 split of ``_kdot``: each operand is
    ``hi + lo`` with ``hi = bf16(x)`` and ``lo = bf16(x − hi)``, and the
    product is ``hi·hi + (hi·lo + lo·hi)`` (about 16 mantissa bits; the
    lo·lo term is dropped). This is the JAX package's definition of the
    mode on every backend; on Hopper it is three bf16 tensor-core passes;
  * ``"float32"``: the exact product in the operands' dtype.

Weights enter the kernels prepared once (:func:`prepare_weight`): a bf16
``(hi,)`` for ``"bfloat16"`` or a ``(hi, lo)`` pair for
``"tensorfloat32"``, in the ``nn.Linear`` layout ``(out, in)``, so the
kernels read bf16 operands at half the bytes of float32; beside them the
planes of ``|w|`` (:func:`kabs` of the split), which the rule products
read (:class:`PreparedWeight`).

float64 activations are cast to float32 before any bf16 rounding, as
``_kdot`` casts them; torch's float64 → bf16 conversion rounds through
float32 as JAX's does, so the plain versions reproduce ``_kdot``'s bf16
operands bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Weight = Union[Tensor, Tuple[Tensor, ...]]

MODES = ("bfloat16", "tensorfloat32", "float32")
_LEVEL = {"bfloat16": 1, "tensorfloat32": 2, "float32": 3}


def mxu_name(precision: Optional[str], default: str = "float32") -> str:
    """A matmul-precision name (or None: follow ``default``) -> the product
    mode (JAX ``vit._mxu_name``)."""
    p = precision if precision is not None else default
    return p if p in ("bfloat16", "tensorfloat32") else "float32"


def islands_exceed_base(base: str, *islands: Optional[str]) -> bool:
    """True if a weight-consuming island asks for more mantissa than the
    ``base`` mode the weights are prepared for (JAX
    ``pallas_kernels.islands_exceed_base``)."""
    b = _LEVEL.get(base, 3)
    return any(_LEVEL.get(m, 3) > b for m in islands if m is not None)


def bf16_head(x: Tensor) -> Tensor:
    """bf16 round-to-nearest-even head of ``x``, kept in float32 (JAX
    ``_bf16_head_f32``; the bit trick there equals torch's RNE cast)."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def split_hi_lo(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``x ≈ hi + lo`` as two bf16 tensors (JAX ``_split_hi_lo``); float64
    input is cast to float32 first."""
    xf = x.to(torch.float32)
    hi = xf.to(torch.bfloat16)
    return hi, (xf - hi.to(torch.float32)).to(torch.bfloat16)


def kabs(w: Weight) -> Weight:
    """abs that understands bf16 splits: ``|hi + lo|`` as
    ``(|hi|, sign(hi)·lo)`` (JAX ``_kabs``); a :class:`PreparedWeight`
    returns the planes it made once."""
    if isinstance(w, PreparedWeight):
        return w.abs
    if isinstance(w, tuple):
        neg = w[0].to(torch.float32) < 0
        return (w[0].abs(),) + tuple(torch.where(neg, -t, t) for t in w[1:])
    return w.abs()


def transpose(w: Weight) -> Weight:
    if isinstance(w, tuple):
        return tuple(t.transpose(-1, -2) for t in w)
    return w.transpose(-1, -2)


class PreparedWeight(tuple):
    """A weight's bf16 split, ``(hi,)`` or ``(hi, lo)`` (a tuple, as
    :func:`kdot` takes it), with the split of ``|w|``, ``kabs(planes)``,
    made once beside it as ``.abs``: the GEMM core's tensor-core products
    read their B operand from shared memory, so the rule products'
    ``|W|`` operands come prepared rather than formed on the fly."""

    abs: Tuple[Tensor, ...]

    def __new__(cls, planes):
        self = super().__new__(cls, tuple(planes))
        self.abs = tuple(t.contiguous() for t in kabs(tuple(self)))
        return self


def prepare_weight(w: Tensor, mode: str) -> PreparedWeight:
    """One weight prepared for the block kernels (JAX ``_flatten_weights``
    per matrix): ``(bf16(w),)`` for ``"bfloat16"``, ``split_hi_lo(w)`` for
    ``"tensorfloat32"``; contiguous, in ``w``'s layout; with its abs planes
    (:class:`PreparedWeight`)."""
    if mode == "bfloat16":
        return PreparedWeight(
            (w.to(torch.float32).to(torch.bfloat16).contiguous(),))
    if mode == "tensorfloat32":
        return PreparedWeight(t.contiguous() for t in split_hi_lo(w))
    raise ValueError(f"block weights are prepared for 'bfloat16' or "
                     f"'tensorfloat32', not {mode!r}")


def kdot(a: Tensor, b: Weight, mode: str) -> Tensor:
    """``a @ b`` in product mode ``mode`` (JAX ``_kdot``): float32
    accumulation, or float64 for float64 ``a``. ``b`` is a tensor or a
    prepared split of a weight (``(hi,)`` or ``(hi, lo)``): a bf16 product
    uses ``hi`` alone, a tf32 one the pair."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    paired = isinstance(b, tuple)

    def d(x, y):
        return x.to(acc) @ y.to(acc)

    if mode == "bfloat16":
        return d(a.to(torch.float32).to(torch.bfloat16),
                 b[0] if paired else b.to(torch.float32).to(torch.bfloat16))
    if mode == "tensorfloat32":
        a_hi, a_lo = split_hi_lo(a)
        if paired:
            if len(b) != 2:
                raise ValueError("a tensorfloat32 product needs (hi, lo) "
                                 "weights")
            b_hi, b_lo = b
        else:
            b_hi, b_lo = split_hi_lo(b)
        return d(a_hi, b_hi) + (d(a_hi, b_lo) + d(a_lo, b_hi))
    if mode != "float32":
        raise ValueError(f"unknown product mode {mode!r}")
    if paired:
        raise ValueError("a float32 product takes unsplit operands")
    return a.to(acc) @ b.to(acc)


__all__ = ["MODES", "mxu_name", "islands_exceed_base", "bf16_head",
           "split_hi_lo", "kabs", "transpose", "PreparedWeight",
           "prepare_weight", "kdot"]
