"""Model factory: a public model name -> (config, state dict on a device).

Port of ``transformer_explainability_tpu/models/registry.py`` (the
reference's constructor functions and ``build_model_with_cfg``): random
weights from a seeded generator, or a local checkpoint file through
``params.convert.load_vit_checkpoint`` / ``load_bert_checkpoint``. Nothing
is downloaded (``params.convert.DEFAULT_CFGS`` keeps the public URLs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from transformer_explainability_torch.explain.generator import (
    _resolve_device)
from transformer_explainability_torch.models import bert as bert_mod
from transformer_explainability_torch.models import vit as vit_mod
from transformer_explainability_torch.models.bert import (BERT_BASE_UNCASED,
                                                          BertConfig)
from transformer_explainability_torch.models.vit import (
    DEIT_BASE_16_224, DEIT_BASE_DISTILLED_16_224, VIT_BASE_16_224,
    VIT_LARGE_16_224, ViTConfig)

VIT_CONFIGS: Dict[str, ViTConfig] = {
    "vit_base_patch16_224": VIT_BASE_16_224,
    "vit_large_patch16_224": VIT_LARGE_16_224,
    "deit_base_patch16_224": DEIT_BASE_16_224,
    "deit_base_distilled_patch16_224": DEIT_BASE_DISTILLED_16_224,
}

BERT_CONFIGS: Dict[str, BertConfig] = {
    "bert-base-uncased": BERT_BASE_UNCASED,
}


def list_models():
    return sorted(VIT_CONFIGS) + sorted(BERT_CONFIGS)


def create_model(name: str, checkpoint: Optional[str] = None, seed: int = 0,
                 device="cuda", **overrides) -> Tuple[Any, Dict[str, Any]]:
    """Returns ``(config, state dict on device)``. ``checkpoint``: a local
    ``.pth`` / ``.npz`` (ViT) or HF directory / ``.safetensors`` / ``.bin``
    (BERT); without one, ``init_params`` drawn on a CPU generator seeded
    from ``seed`` and moved to ``device``, so that a seed is one model on
    every device (other numbers than JAX's ``PRNGKey``).
    ``overrides`` replace config fields (e.g. ``num_classes=2``)."""
    if name in VIT_CONFIGS:
        cfg, mod = VIT_CONFIGS[name], vit_mod
    elif name in BERT_CONFIGS:
        cfg, mod = BERT_CONFIGS[name], bert_mod
    else:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{list_models()}")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    device = _resolve_device(device)        # no CPU fallback
    if checkpoint:
        from transformer_explainability_torch.params import convert
        load = (convert.load_vit_checkpoint if mod is vit_mod
                else convert.load_bert_checkpoint)
        return cfg, {k: v.to(device) for k, v in
                     load(checkpoint, cfg).items()}
    gen = torch.Generator().manual_seed(seed)
    return cfg, mod.init_params(cfg, generator=gen, device=device)
