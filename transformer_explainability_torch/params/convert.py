"""Weight converters into the port's timm-named state dicts.

Counterpart of ``transformer_explainability_tpu/params/convert.py``
(``vit_state_dict_from_params``). Takes the JAX parameter pytree with array
leaves that numpy reads (numpy arrays, or JAX arrays converted by the
caller) and needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from transformer_explainability_torch.models.vit import ViTConfig

_BLOCK_LEAVES = (
    # (state-dict name, pytree module, leaf, transpose (in, out) -> (out, in))
    ("norm1.weight", "norm1", "scale", False),
    ("norm1.bias", "norm1", "bias", False),
    ("attn.qkv.weight", "qkv", "kernel", True),
    ("attn.qkv.bias", "qkv", "bias", False),
    ("attn.proj.weight", "proj", "kernel", True),
    ("attn.proj.bias", "proj", "bias", False),
    ("norm2.weight", "norm2", "scale", False),
    ("norm2.bias", "norm2", "bias", False),
    ("mlp.fc1.weight", "fc1", "kernel", True),
    ("mlp.fc1.bias", "fc1", "bias", False),
    ("mlp.fc2.weight", "fc2", "kernel", True),
    ("mlp.fc2.bias", "fc2", "bias", False),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))          # an owned, writable copy


def vit_params_from_jax(tree: Mapping[str, Any],
                        cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """JAX ViT pytree (``vit.init_params`` layout: per-block leaves stacked on
    a leading depth axis, Linear kernels ``(in, out)``, patch kernel
    ``(C·P·P, D)``) -> the port's state dict (timm names, weights
    ``(out, in)``, patch conv ``(D, C, P, P)``) on the CPU, in the tree's
    dtype."""
    if "dist_token" in tree:
        raise NotImplementedError("distilled DeiT is not ported yet "
                                  "(ROADMAP A3)")
    D, C, P = cfg.embed_dim, cfg.in_chans, cfg.patch_size
    pe = np.asarray(tree["patch_embed"]["kernel"])
    sd = {
        "patch_embed.proj.weight": _t(pe.T.reshape(D, C, P, P)),
        "patch_embed.proj.bias": _t(tree["patch_embed"]["bias"]),
        "cls_token": _t(np.asarray(tree["cls_token"]).reshape(1, 1, D)),
        "pos_embed": _t(np.asarray(tree["pos_embed"])[None]),
    }
    blocks = tree["blocks"]
    for name, mod, leaf, transpose in _BLOCK_LEAVES:
        if leaf not in blocks[mod]:           # e.g. qkv without bias
            continue
        stacked = np.asarray(blocks[mod][leaf])
        for i in range(cfg.depth):
            a = stacked[i]
            sd[f"blocks.{i}.{name}"] = _t(a.T if transpose else a)
    sd["norm.weight"] = _t(tree["norm"]["scale"])
    sd["norm.bias"] = _t(tree["norm"]["bias"])
    sd["head.weight"] = _t(np.asarray(tree["head"]["kernel"]).T)
    sd["head.bias"] = _t(tree["head"]["bias"])
    return sd
