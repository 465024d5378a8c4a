"""User-facing demo API: the reference notebooks' surface
(``example.ipynb``'s ``generate_visualization(image, class_index)`` and
``print_top_classes``; ``DeiT_example.ipynb``).

Port of ``transformer_explainability_tpu/demo.py``::

    from transformer_explainability_torch import demo
    vis = demo.Demo(params)                  # or Demo.from_checkpoint(path)
    overlay = vis.generate_visualization(pil_image, class_index=243)
    vis.print_top_classes(pil_image)

It runs on the card (``device="cuda"``) unless told otherwise; the heatmap
is resized, normalised and coloured there (:mod:`.utils.image`,
:mod:`.utils.render`'s ``jet`` table) and read back once, as the overlay.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from transformer_explainability_torch.explain.generator import (
    Explainer, _check_fp32_matmul)
from transformer_explainability_torch.models.vit import (VIT_BASE_16_224,
                                                         ViTConfig)
from transformer_explainability_torch.utils.image import resize_bilinear_chw
from transformer_explainability_torch.utils.render import apply_colormap

# the normalisation of the reference notebooks
# (example.ipynb: Normalize(mean=[0.5]*3, std=[0.5]*3))
MEAN = np.array([0.5, 0.5, 0.5], np.float32)
STD = np.array([0.5, 0.5, 0.5], np.float32)

_CLASSES_PATH = os.path.join(os.path.dirname(__file__), "utils",
                             "imagenet_classes.json")


def imagenet_classes() -> dict:
    """index (int) -> human-readable label (the public ILSVRC2012 label
    table, a copy of the JAX package's ``utils/imagenet_classes.json``)."""
    with open(_CLASSES_PATH) as f:
        return {int(k): v for k, v in json.load(f).items()
                if not k.startswith("_")}


def preprocess(image, size: int = 224) -> np.ndarray:
    """PIL image / HWC array in [0, 255] or [0, 1] -> normalised (C, H, W)."""
    if hasattr(image, "convert"):          # PIL
        image = image.convert("RGB").resize((size, size))
        arr = np.asarray(image, np.float32) / 255.0
    else:
        arr = np.asarray(image, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
    if arr.shape[-1] == 3:                 # HWC -> CHW
        arr = ((arr - MEAN) / STD).transpose(2, 0, 1)
    return arr


def show_cam_on_image(img_hwc, mask_hw) -> np.ndarray:
    """JET overlay (the notebooks' ``show_cam_on_image``): heatmap + image,
    divided by its max. Inputs in [0, 1], numpy or tensors (the mask's
    device computes); returns HWC float64 numpy."""
    mask = torch.as_tensor(mask_hw).to(torch.float32)
    heatmap = apply_colormap("jet", mask)[..., :3]
    cam = heatmap + torch.as_tensor(img_hwc, device=mask.device).to(
        torch.float32)
    return (cam / cam.max()).cpu().numpy()


def render_token_heatmap(heat, img01_hwc, grid: int = 14,
                         size: int = 224) -> np.ndarray:
    """Token-relevance row -> rendered overlay, the notebook pipeline:
    (grid·grid,) -> grid × grid -> bilinear upsample to ``size`` -> min-max
    normalise -> JET overlay on the [0, 1] image (JAX
    ``demo.render_token_heatmap``). ``heat`` numpy or a tensor, computed on
    its device; returns HWC float64 numpy in [0, 1]."""
    hm = torch.as_tensor(heat).to(torch.float32).reshape(1, 1, grid, grid)
    hm = resize_bilinear_chw(hm, size, size)[0, 0]
    hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-12)
    return show_cam_on_image(np.clip(np.asarray(img01_hwc), 0, 1), hm)


class Demo:
    """Single-image explanation visualiser on a ViT (JAX ``demo.Demo``),
    on ``device`` (the card by default)."""

    def __init__(self, params, cfg: ViTConfig = VIT_BASE_16_224,
                 variant: str = "ours", device="cuda"):
        self.cfg = cfg
        self.explainer = Explainer(params, cfg, device, variant=variant)
        self.device = self.explainer.device

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ViTConfig = VIT_BASE_16_224,
                        **kw) -> "Demo":
        from transformer_explainability_torch.params.convert import (
            load_vit_checkpoint)
        return cls(load_vit_checkpoint(path, cfg), cfg, **kw)

    def generate_visualization(self, image, class_index: Optional[int] = None,
                               method: str = "transformer_attribution",
                               start_layer: int = 0) -> np.ndarray:
        """The notebook API: heatmap -> grid × grid -> bilinear upsample ->
        min-max normalise -> JET overlay on the unnormalised image. Returns
        HWC float RGB in [0, 1]."""
        x = preprocess(image)
        idx = [-1 if class_index is None else int(class_index)]
        hm = self.explainer.explain(x[None], indices=idx, method=method,
                                    start_layer=start_layer)[0]
        g, S = self.cfg.grid, self.cfg.img_size
        img01 = (x.transpose(1, 2, 0) * STD) + MEAN
        if hm.ndim == 1 and hm.numel() == g * g:   # token row
            return render_token_heatmap(hm, img01, g, S)
        if tuple(hm.shape) != (S, S):
            hm = resize_bilinear_chw(hm[None, None], S, S)[0, 0]
        hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-12)
        return show_cam_on_image(np.clip(img01, 0, 1), hm)

    def predict(self, image) -> np.ndarray:
        """The logits of one image (the model's forward)."""
        model = self.explainer.model
        x = torch.as_tensor(preprocess(image)[None], device=self.device)
        x = x.to(model.cls_token.dtype)
        _check_fp32_matmul(x.device, x.dtype)
        return model(x)[0].cpu().numpy()

    def print_top_classes(self, image, k: int = 5) -> list:
        """Softmax top-k with labels (example.ipynb ``print_top_classes``)."""
        logits = self.predict(image)
        probs = np.exp(logits - logits.max())
        probs = probs / probs.sum()
        top = np.argsort(logits)[::-1][:k]
        names = imagenet_classes()
        rows = []
        for i in top:
            row = (int(i), names.get(int(i), str(i)), float(logits[i]),
                   float(probs[i]))
            rows.append(row)
            print(f"class {row[0]:4d} : {row[1]:40s} logit {row[2]:8.3f} "
                  f"prob {row[3]*100:5.1f}%")
        return rows
