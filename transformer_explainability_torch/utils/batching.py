"""Batch-shape helpers (port of
``transformer_explainability_tpu/utils/batching.py``).

JAX pads a ragged batch up to a power-of-two bucket so that each jitted
program compiles for few shapes. The port runs any batch size as it is and
needs no buckets in its own loops; these are kept for callers that want
JAX's shapes (the ERASER pipeline's ``_padded_batch``). Padded rows are
copies of the last row, so per-row normalisations stay finite.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def bucket_size(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return max(1, 1 << (max(1, n) - 1).bit_length())


def pad_axis0(arr, target: int) -> Tensor:
    """Repeat the last row of ``arr`` along axis 0 up to ``target`` rows."""
    arr = torch.as_tensor(arr)
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"batch {n} exceeds target {target}")
    reps = arr[-1:].expand(target - n, *arr.shape[1:])
    return torch.cat([arr, reps], dim=0)


__all__ = ["bucket_size", "pad_axis0"]
