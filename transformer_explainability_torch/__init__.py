"""PyTorch/CUDA port of the transformer-explainability package.

Mirrors the layout of ``transformer_explainability_tpu`` (the JAX reference,
kept beside it): ``ops/relprop.py`` is the rule library, ``ops/kernels.py``
holds the hand-written CUDA kernels' wrappers with their plain PyTorch
versions, ``models/vit.py`` and ``models/bert.py`` the forward and fused
reverse passes, ``params/convert.py`` the weight converters, and
``explain/generator.py`` / ``explain/bert_generator.py`` the ``Explainer`` /
``BertExplainer`` entry points. The user's entry points beside them:
``models/registry.py`` (``create_model``, ``list_models``: a public model
name and, optionally, a checkpoint file -> config and state dict on the
card), ``demo.py`` (``Demo``), and the evaluation harnesses
``eval/seg.py``, ``eval/visualize.py`` and ``eval/perturbation.py``
(``python -m transformer_explainability_torch.eval.<name> --device ...``),
with their data readers under ``data/`` and numpy metrics, colormaps and
device image ops under ``utils/``. The training paths: ``train.py`` (the
ViT trainer) with the train-state checkpoints of ``utils/checkpoint.py``,
and the ERASER pipeline under ``rationale/`` (``python -m
transformer_explainability_torch.rationale.pipeline --device ...``).

This package imports ``torch`` and numpy only (and scipy in the
rationale scorer); h5py, Pillow, OpenCV, safetensors, tqdm, scikit-learn
and transformers are imported by the functions that need them, and raise
``ImportError`` there when missing. CUDA sources
under ``csrc/`` are compiled with ``nvcc`` at first use on a CUDA tensor;
importing the package needs no GPU, no ``nvcc`` and no JAX.
"""

from transformer_explainability_torch.explain.bert_generator import (
    BertExplainer)
from transformer_explainability_torch.explain.generator import Explainer
from transformer_explainability_torch.models.bert import (
    BERT_BASE_UNCASED, BertConfig)
from transformer_explainability_torch.models.registry import (
    create_model, list_models)
from transformer_explainability_torch.models.vit import (
    DEIT_BASE_16_224, DEIT_BASE_DISTILLED_16_224, VIT_BASE_16_224,
    VIT_LARGE_16_224, ViTConfig, VisionTransformer, init_params)

__all__ = ["BERT_BASE_UNCASED", "BertConfig", "BertExplainer",
           "DEIT_BASE_16_224", "DEIT_BASE_DISTILLED_16_224", "Explainer",
           "VIT_BASE_16_224", "VIT_LARGE_16_224", "ViTConfig",
           "VisionTransformer", "create_model", "init_params",
           "list_models"]
