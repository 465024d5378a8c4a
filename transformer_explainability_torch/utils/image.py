"""Image operations on the caller's device, in place of the JAX package's
g++ host library (``transformer_explainability_tpu/native``):

  * :func:`resize_bilinear_chw` — ``(B, C, H, W)`` -> ``(B, C, OH, OW)``,
    bilinear with half-pixel centres (``align_corners=False``), as
    ``native.resize_bilinear_chw``;
  * :func:`normalize_chw` — uint8 ``(B, H, W, 3)`` -> float32
    ``(B, 3, H, W)``, ``(x / 255 − mean) / std``, as ``native.normalize_chw``.

Both are PyTorch operations on the input's device (``normalize_chw``
optionally moves it first): the harnesses' heatmaps are already on the
card, so they stay there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def resize_bilinear_chw(x, out_h: int, out_w: int) -> Tensor:
    """float32 ``(B, C, H, W)`` -> ``(B, C, out_h, out_w)`` on ``x``'s
    device, bilinear, ``align_corners=False`` (no antialiasing, as the
    native kernel)."""
    x = torch.as_tensor(x).to(torch.float32)
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False)


def normalize_chw(images, mean, std,
                  device: Optional[torch.device] = None) -> Tensor:
    """uint8 ``(B, H, W, 3)`` -> float32 ``(B, 3, H, W)``:
    ``(x · (1/255) − mean) · (1/std)``, the native kernel's arithmetic."""
    images = torch.as_tensor(images, device=device)
    if images.dtype != torch.uint8 or images.shape[-1] != 3:
        raise ValueError(f"want uint8 (B, H, W, 3), got {images.dtype} "
                         f"{tuple(images.shape)}")
    kw = dict(dtype=torch.float32, device=images.device)
    m = torch.as_tensor(mean, **kw)
    inv_std = 1.0 / torch.as_tensor(std, **kw)
    scale = torch.tensor(1.0 / 255.0, **kw)
    x = (images.to(torch.float32) * scale - m) * inv_std
    return x.permute(0, 3, 1, 2).contiguous()
