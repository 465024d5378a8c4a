"""PyTorch/CUDA port of the transformer-explainability package.

Mirrors the layout of ``transformer_explainability_tpu`` (the JAX reference,
kept beside it): ``ops/relprop.py`` is the rule library, ``ops/kernels.py``
holds the hand-written CUDA kernels' wrappers with their plain PyTorch
versions, ``models/vit.py`` the ViT forward and fused reverse pass,
``params/convert.py`` the weight converter and ``explain/generator.py`` the
``Explainer`` entry point.

This package imports ``torch`` and numpy only. CUDA sources under ``csrc/``
are compiled with ``nvcc`` at first use on a CUDA tensor; importing the
package needs no GPU, no ``nvcc`` and no JAX.
"""

from transformer_explainability_torch.explain.generator import Explainer
from transformer_explainability_torch.models.vit import (
    VIT_BASE_16_224, ViTConfig, VisionTransformer, init_params)

__all__ = ["Explainer", "VIT_BASE_16_224", "ViTConfig", "VisionTransformer",
           "init_params"]
