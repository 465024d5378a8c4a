"""Weight converters into the port's state dicts (timm names for ViT, Hugging
Face names for BERT).

Counterpart of ``transformer_explainability_tpu/params/convert.py``
(``vit_state_dict_from_params``, ``bert_state_dict_from_params``). Takes
the JAX parameter pytree with array leaves that numpy reads (numpy arrays,
or JAX arrays converted by the caller) and needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from transformer_explainability_torch.models.bert import BertConfig
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
    ``(C·P·P, D)``; a distilled config's ``dist_token`` and ``head_dist``)
    -> the port's state dict (timm names, weights ``(out, in)``, patch conv
    ``(D, C, P, P)``) on the CPU, in the tree's dtype."""
    if cfg.distilled != ("dist_token" in tree):
        raise ValueError("the tree's DIST token does not match the config's "
                         f"distilled={cfg.distilled}")
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
    if cfg.distilled:
        sd["dist_token"] = _t(np.asarray(tree["dist_token"]).reshape(1, 1, D))
        sd["head_dist.weight"] = _t(np.asarray(tree["head_dist"]["kernel"]).T)
        sd["head_dist.bias"] = _t(tree["head_dist"]["bias"])
    return sd


_BERT_LAYER_LEAVES = (
    # (HF module under encoder.layer.{i}, pytree module, is a Linear)
    ("attention.self.query", "q", True),
    ("attention.self.key", "k", True),
    ("attention.self.value", "v", True),
    ("attention.output.dense", "attn_out", True),
    ("attention.output.LayerNorm", "attn_ln", False),
    ("intermediate.dense", "inter", True),
    ("output.dense", "out", True),
    ("output.LayerNorm", "out_ln", False),
)


def bert_params_from_jax(tree: Mapping[str, Any],
                         cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """JAX BERT pytree (``bert.init_params`` layout: per-layer leaves stacked
    on a leading layer axis, Linear kernels ``(in, out)``) -> the port's
    state dict in the HF classification layout that JAX
    ``bert_state_dict_from_params`` exports (``bert.``-prefixed encoder,
    ``classifier``, weights ``(out, in)``, the ``position_ids`` buffer), on
    the CPU, in the tree's dtype."""
    emb, lay = tree["embeddings"], tree["layers"]
    e = "bert.embeddings."
    sd = {
        e + "position_ids": torch.arange(cfg.max_position_embeddings)[None],
        e + "word_embeddings.weight": _t(emb["word"]),
        e + "position_embeddings.weight": _t(emb["position"]),
        e + "token_type_embeddings.weight": _t(emb["token_type"]),
        e + "LayerNorm.weight": _t(emb["ln"]["scale"]),
        e + "LayerNorm.bias": _t(emb["ln"]["bias"]),
        "bert.pooler.dense.weight": _t(np.asarray(tree["pooler"]["kernel"]).T),
        "bert.pooler.dense.bias": _t(tree["pooler"]["bias"]),
    }
    for hf_name, mod, is_linear in _BERT_LAYER_LEAVES:
        w = np.asarray(lay[mod]["kernel" if is_linear else "scale"])
        b = np.asarray(lay[mod]["bias"])
        for i in range(cfg.num_layers):
            base = f"bert.encoder.layer.{i}.{hf_name}"
            sd[base + ".weight"] = _t(w[i].T if is_linear else w[i])
            sd[base + ".bias"] = _t(b[i])
    sd["classifier.weight"] = _t(np.asarray(tree["classifier"]["kernel"]).T)
    sd["classifier.bias"] = _t(tree["classifier"]["bias"])
    return sd
