"""Plain PyTorch versions of the tensor-parallel MLP reverse kernels B10a and
B10b.

Port of the kernel-body math of
``transformer_explainability_tpu/ops/pallas_kernels.py`` with a leading
batch dimension written out:

  * :func:`mlp_rev_tp_phase1_plain` = ``_mlp_rev_tp1_kernel``: LN2 forward,
    the fc1/GELU recompute, the partials ``fc2_pre``, ``|hg|·|W2|`` and
    ``g_xn2`` of this shard, and the anchor ``fc1_pre``;
  * :func:`mlp_rev_tp_phase2_plain` = ``_mlp_rev_tp2_kernel``: the fc2 rule's
    scatter to this shard's columns, the fc1 rule's divide at phase 1's
    anchor, and the partials ``num_w``, ``num_a``.

Between and after them the caller all-reduces the (B, n, D) partials
(:mod:`..parallel.tensor`). Every product goes through
:func:`.precision.kdot` in the mode the caller names (in ``float32`` mode
these are the JAX jnp fallbacks); the weights are this shard's slices in
the ``nn.Linear`` layout, ``w1_l`` (M/k, D) and ``w2_l`` (D, M/k), as
tensors or as prepared splits (:func:`.precision.prepare_weight`). These
are the CPU path of the wrappers in :mod:`.kernels` and the oracle that
``csrc/mlp_rev_tp.cu`` is held to.
"""

from __future__ import annotations

from typing import Tuple

import torch

from transformer_explainability_torch.ops.block_math import (
    gelu_exact, gelu_grad, ln_fwd)
from transformer_explainability_torch.ops.precision import (
    Weight, kabs, kdot, transpose)
from transformer_explainability_torch.ops.relprop import safe_divide

Tensor = torch.Tensor


def mlp_rev_tp_phase1_plain(x_mid: Tensor, g_out: Tensor, ln2s: Tensor,
                            ln2b: Tensor, b1_l: Tensor, w1_l: Weight,
                            w2_l: Weight, eps: float, mxu: str,
                            rule_mxu: str) -> Tuple[Tensor, ...]:
    """Returns ``(fc1_pre_l (B, n, M/k), fc2_pre_l, axw2_l, g_xn2_l (B, n,
    D))``: the anchor and this shard's three partials."""
    xn2, _, _ = ln_fwd(x_mid, ln2s, ln2b, eps)
    fc1_pre = kdot(xn2, transpose(w1_l), mxu)
    h1 = fc1_pre + b1_l
    hg = gelu_exact(h1)
    fc2_pre = kdot(hg, transpose(w2_l), mxu)
    axw2 = kdot(hg.abs(), transpose(kabs(w2_l)), rule_mxu)
    g_h1 = kdot(g_out, w2_l, mxu) * gelu_grad(h1)
    return fc1_pre, fc2_pre, axw2, kdot(g_h1, w1_l, mxu)


def mlp_rev_tp_phase2_plain(x_mid: Tensor, Sr: Tensor, fc1_pre_l: Tensor,
                            ln2s: Tensor, ln2b: Tensor, b1_l: Tensor,
                            w1_l: Weight, w2_l: Weight, eps: float,
                            rule_mxu: str) -> Tuple[Tensor, Tensor]:
    """Returns this shard's partials ``(num_w_l, num_a_l)``, each
    (B, n, D). ``Sr`` is the fc2 rule's divide from the all-reduced phase-1
    partials; ``fc1_pre_l`` is phase 1's anchor."""
    xn2, _, _ = ln_fwd(x_mid, ln2s, ln2b, eps)
    hg = gelu_exact(fc1_pre_l + b1_l)
    R2 = 0.5 * (hg * kdot(Sr, w2_l, rule_mxu)
                + hg.abs() * kdot(Sr, kabs(w2_l), rule_mxu))
    aw1 = kabs(w1_l)
    axw1 = kdot(xn2.abs(), transpose(aw1), rule_mxu)
    S1 = safe_divide(R2, 0.5 * (fc1_pre_l + axw1))
    return kdot(S1, w1_l, rule_mxu), kdot(S1, aw1, rule_mxu)


__all__ = ["mlp_rev_tp_phase1_plain", "mlp_rev_tp_phase2_plain"]
