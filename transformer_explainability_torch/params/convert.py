"""Weight converters and checkpoint loaders into the port's state dicts
(timm names for ViT, Hugging Face names for BERT).

Counterpart of ``transformer_explainability_tpu/params/convert.py``:

  * ``vit_params_from_jax`` / ``bert_params_from_jax`` take the JAX
    parameter pytree with array leaves that numpy reads (numpy arrays, or
    JAX arrays converted by the caller) and need no JAX;
  * ``vit_params_from_torch_state_dict`` / ``bert_params_from_torch_state_dict``
    check a public state dict (timm / DeiT, Hugging Face) against the
    config and return the port's state dict in one dtype;
  * ``load_vit_checkpoint`` (:392) and ``load_bert_checkpoint`` (:256) read
    the files users hold: a timm ``.pth`` (flat, or under ``"model"`` as
    DeiT's hub files are, or under ``"state_dict"``), an ``.npz`` in timm
    keys or in the JAX package's own keystr layout; an HF directory,
    ``model.safetensors`` or ``pytorch_model.bin``;
  * ``adapt_first_conv``, ``adapt_classifier``, ``resize_pos_embed`` and
    ``adapt_pretrained`` (:300-378) fit a checkpoint to another channel
    count, class count or image size;
  * ``save_vit_npz`` / ``load_npz_pytree`` (:380-390), the ``.npz``
    interchange in timm keys (``utils/checkpoint.py``).

Everything here runs on the CPU; the caller moves the state dict to its
device. ``safetensors`` is imported only to read a ``.safetensors`` file.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from transformer_explainability_torch.models import bert as bert_mod
from transformer_explainability_torch.models import vit as vit_mod
from transformer_explainability_torch.models.bert import BertConfig
from transformer_explainability_torch.models.vit import ViTConfig

Tensor = torch.Tensor

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
    if "classifier" in tree:       # a bare BertModel checkpoint has none
        sd["classifier.weight"] = _t(np.asarray(tree["classifier"]["kernel"]).T)
        sd["classifier.bias"] = _t(tree["classifier"]["bias"])
    return sd



# ---------------------------------------------------------------------------
# Public state dicts and checkpoint files
# ---------------------------------------------------------------------------

def _tensor(v, dtype: torch.dtype) -> Tensor:
    """A state-dict value (tensor or numpy array) -> an owned CPU tensor."""
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v))
    return v.detach().to("cpu", dtype).clone()


def _expected(model) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _check_keys(sd: Mapping[str, Any], want: Dict[str, tuple],
                optional: tuple, what: str) -> None:
    missing = sorted(k for k in want if k not in sd and k not in optional)
    if missing:
        raise KeyError(f"{what}: the state dict lacks {len(missing)} keys "
                       f"the config needs, e.g. {missing[:4]}")
    for k, shape in want.items():
        if k in sd and tuple(sd[k].shape) != shape:
            raise ValueError(f"{what}: {k} has shape {tuple(sd[k].shape)}, "
                             f"the config wants {shape} (a checkpoint of "
                             "another size: see adapt_pretrained)")


def vit_params_from_torch_state_dict(sd: Mapping[str, Any], cfg: ViTConfig,
                                     dtype: torch.dtype = torch.float32
                                     ) -> Dict[str, Tensor]:
    """A timm / DeiT / reference ViT state dict (JAX
    ``vit_params_from_torch_state_dict``; tensors or numpy arrays) -> the
    port's state dict on the CPU in ``dtype``. The keys are already the
    port's: what is checked is that every key the config needs is there at
    its shape, that the checkpoint's qkv bias and DIST token match
    ``cfg.qkv_bias`` and ``cfg.distilled`` (a mismatch raises, naming the
    field to override), and keys the port has no use for are dropped."""
    has_bias = "blocks.0.attn.qkv.bias" in sd
    if cfg.qkv_bias != has_bias:
        raise ValueError(f"the checkpoint {'has' if has_bias else 'lacks'} "
                         f"qkv biases but the config has qkv_bias="
                         f"{cfg.qkv_bias}; pass qkv_bias={has_bias}")
    if cfg.distilled != ("dist_token" in sd):
        raise ValueError("the checkpoint's DIST token does not match the "
                         f"config's distilled={cfg.distilled}")
    want = _expected(vit_mod.VisionTransformer(cfg, device="meta"))
    _check_keys(sd, want, (), "ViT checkpoint")
    return {k: _tensor(sd[k], dtype) for k in want}


def bert_params_from_torch_state_dict(sd: Mapping[str, Any], cfg: BertConfig,
                                      dtype: torch.dtype = torch.float32
                                      ) -> Dict[str, Tensor]:
    """An HF ``BertForSequenceClassification`` or bare ``BertModel`` state
    dict (JAX ``bert_params_from_torch_state_dict``: ``bert.`` prefix or
    none; tensors or numpy arrays) -> the port's ``bert.``-prefixed state
    dict on the CPU in ``dtype``, with the ``position_ids`` buffer made
    anew (as :func:`bert_params_from_jax` makes it) and ``classifier.*``
    where the checkpoint has it (a bare ``BertModel`` has none, and then
    neither has the result)."""
    if not any(k.startswith("bert.") for k in sd):
        sd = {(k if k.startswith("classifier.") else "bert." + k): v
              for k, v in sd.items()}
    want = _expected(bert_mod.BertForSequenceClassification(cfg,
                                                            device="meta"))
    pos = "bert.embeddings.position_ids"
    optional = (pos, "classifier.weight", "classifier.bias")
    _check_keys(sd, want, optional, "BERT checkpoint")
    if ("classifier.weight" in sd) != ("classifier.bias" in sd):
        raise KeyError("BERT checkpoint: classifier.weight and "
                       "classifier.bias come together")
    out = {pos: torch.arange(cfg.max_position_embeddings)[None]}
    out.update({k: _tensor(sd[k], dtype) for k in want
                if k != pos and k in sd})
    return out


def _torch_load(path: str):
    # tensors, containers and plain values only: unpickling a file from
    # outside the program may not run its code (a checkpoint that pickles
    # other objects raises; re-save its state dict)
    return torch.load(path, map_location="cpu", weights_only=True)


_KEYSTR = re.compile(r"\['([^']*)'\]")


def _tree_from_keystr(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{"['blocks']['fc1']['kernel']": a, ...}`` (JAX
    ``utils/checkpoint.save_pytree``'s ``keystr`` keys) -> the nested
    pytree, parsed with plain string code."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        path = _KEYSTR.findall(key)
        if not path or "".join(f"['{p}']" for p in path) != key:
            raise ValueError(f"not a JAX keystr key: {key!r}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def load_vit_checkpoint(path: str, cfg: ViTConfig,
                        dtype: torch.dtype = torch.float32
                        ) -> Dict[str, Tensor]:
    """Load a ViT checkpoint file into the port's state dict on the CPU
    (JAX ``load_vit_checkpoint``): a timm ``.pth`` whose state dict is
    flat, under ``"model"`` (DeiT's hub files) or under ``"state_dict"``;
    or an ``.npz`` in timm keys (:func:`save_vit_npz`) or in the JAX
    package's keystr layout (its ``save_vit_npz``), the latter through
    :func:`vit_params_from_jax`. A ``.pth`` is read with
    ``weights_only=True``: tensors, containers and plain values."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            sd = dict(f)
        if "patch_embed.proj.weight" not in sd:
            tree = _tree_from_keystr(sd)
            sd = vit_params_from_jax(tree, cfg)
    else:
        ckpt = _torch_load(path)
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return vit_params_from_torch_state_dict(sd, cfg, dtype)


def load_bert_checkpoint(path_or_name: str, cfg: BertConfig,
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, Tensor]:
    """Load an HF-format BERT checkpoint into the port's state dict on the
    CPU (JAX ``load_bert_checkpoint``): a directory (its
    ``model.safetensors``, else its ``pytorch_model.bin``), a
    ``.safetensors`` file (needs the ``safetensors`` package) or a torch
    ``.bin`` / ``.pt`` (flat or under ``"state_dict"``)."""
    path = path_or_name
    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        path = st if os.path.exists(st) else os.path.join(
            path, "pytorch_model.bin")
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError("reading a .safetensors checkpoint needs the "
                              "safetensors package") from e
        sd = load_file(path)
    else:
        sd = _torch_load(path)
        sd = sd.get("state_dict", sd)
    return bert_params_from_torch_state_dict(sd, cfg, dtype)


# Public checkpoint registry (JAX ``DEFAULT_CFGS``: the reference's
# ``default_cfgs`` and the DeiT hub URLs). Documentation only: nothing here
# downloads; pass a local file to load_vit_checkpoint.
DEFAULT_CFGS = {
    "vit_base_patch16_224": {
        "url": "https://github.com/rwightman/pytorch-image-models/releases/"
               "download/v0.1-vitjx/jx_vit_base_p16_224-80ecf9dd.pth",
        "num_classes": 1000, "in_chans": 3,
    },
    "vit_large_patch16_224": {
        "url": "https://github.com/rwightman/pytorch-image-models/releases/"
               "download/v0.1-vitjx/jx_vit_large_p16_224-4ee7a4dc.pth",
        "num_classes": 1000, "in_chans": 3,
    },
    "deit_base_patch16_224": {
        "url": "https://dl.fbaipublicfiles.com/deit/"
               "deit_base_patch16_224-b5f2ef4d.pth",
        "num_classes": 1000, "in_chans": 3,
    },
    "deit_base_distilled_patch16_224": {
        "url": "https://dl.fbaipublicfiles.com/deit/"
               "deit_base_distilled_patch16_224-df68dfff.pth",
        "num_classes": 1000, "in_chans": 3, "distilled": True,
    },
}


# ---------------------------------------------------------------------------
# Adapters: another channel count, class count or image size
# ---------------------------------------------------------------------------

def adapt_first_conv(weight: Tensor, in_chans: int) -> Tensor:
    """Fit a patch-embedding weight ``(D, 3, P, P)`` trained on RGB to
    ``in_chans`` input channels (JAX ``adapt_first_conv``, the reference's
    ``helpers.py:99-134``): 1 channel sums over RGB; 3 returns it as it
    is; otherwise the channels are tiled and rescaled by 3 / in_chans. In
    float32, as JAX computes it."""
    w = weight.to(torch.float32)
    if w.shape[1] != 3:
        raise ValueError(f"adapt_first_conv takes an RGB kernel, got "
                         f"{w.shape[1]} channels")
    if in_chans == 1:
        return w.sum(dim=1, keepdim=True)
    if in_chans == 3:
        return w
    repeat = -(-in_chans // 3)
    scale = torch.tensor(3.0 / in_chans, dtype=torch.float32)
    return w.repeat(1, repeat, 1, 1)[:, :in_chans] * scale


def adapt_classifier(weight: Tensor, bias: Tensor, num_classes: int,
                     pretrained_classes: int,
                     generator: Optional[torch.Generator] = None):
    """Resize a classifier head ``(classes, D)`` (JAX ``adapt_classifier``,
    the reference's ``helpers.py:137-147``): equal sizes keep it, 1001 ->
    1000 drops the background class (row 0), any other size draws a new
    head in float32, trunc-normal (std 0.02, cut at ±2σ) from
    ``generator`` (a seed-0 CPU generator when None), drawn on the
    generator's device and moved to the weight's, with a zero bias. The
    same seed gives other numbers than JAX's ``PRNGKey``. Returns
    ``(weight, bias)``."""
    if num_classes == pretrained_classes:
        return weight, bias
    if num_classes == 1000 and pretrained_classes == 1001:
        return weight[1:], bias[1:]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    D = weight.shape[1]
    new = torch.nn.init.trunc_normal_(
        torch.empty(num_classes, D, dtype=torch.float32,
                    device=generator.device),
        std=0.02, a=-0.04, b=0.04, generator=generator)
    return new.to(weight.device), torch.zeros(
        num_classes, dtype=torch.float32, device=weight.device)


def resize_pos_embed(pos_embed: Tensor, new_tokens: int,
                     num_prefix_tokens: int = 1) -> Tensor:
    """Resize a position table ``(1, prefix + g·g, D)`` (or without the
    leading 1) to ``new_tokens`` rows for another image size (JAX
    ``resize_pos_embed``): the prefix rows (CLS, and DIST when
    ``num_prefix_tokens`` is 2) are kept, the patch grid is resized
    bilinearly with half-pixel centres, as ``jax.image.resize`` does:
    upsampling is ``F.interpolate(mode="bilinear", align_corners=False)``,
    which computes the same; downsampling adds ``antialias=True``, the
    triangle filter widened by the scale, as JAX's (the gap to JAX is
    measured in ``tests/test_torch_checkpoints.py``). Same leading shape
    and dtype as the input."""
    pe = pos_embed[0] if pos_embed.ndim == 3 else pos_embed
    if pe.shape[0] == new_tokens:
        return pos_embed
    prefix, grid = pe[:num_prefix_tokens], pe[num_prefix_tokens:]
    g_old = int(round(grid.shape[0] ** 0.5))
    g_new = int(round((new_tokens - num_prefix_tokens) ** 0.5))
    if g_old * g_old != grid.shape[0] or (
            g_new * g_new != new_tokens - num_prefix_tokens):
        raise ValueError(f"position grids must be square: {grid.shape[0]} "
                         f"-> {new_tokens - num_prefix_tokens} rows")
    x = grid.reshape(g_old, g_old, -1).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(g_new, g_new), mode="bilinear",
                      align_corners=False, antialias=g_new < g_old)
    out = torch.cat([prefix, x[0].permute(1, 2, 0).reshape(g_new * g_new,
                                                            -1)])
    return out[None] if pos_embed.ndim == 3 else out


def adapt_pretrained(params: Mapping[str, Tensor], cfg: ViTConfig,
                     pretrained_classes: int = 1000,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Tensor]:
    """Every checkpoint -> model adaptation in one call (JAX
    ``adapt_pretrained``): the first conv to ``cfg.in_chans`` channels, the
    head (and ``head_dist``) to ``cfg.num_classes``, the position table to
    ``cfg.num_tokens`` rows. Takes and returns the port's state dict."""
    params = dict(params)
    w = params["patch_embed.proj.weight"]
    if w.shape[1] != cfg.in_chans:
        params["patch_embed.proj.weight"] = adapt_first_conv(w, cfg.in_chans)
    for head in ("head", "head_dist"):
        if head + ".weight" in params:
            params[head + ".weight"], params[head + ".bias"] = \
                adapt_classifier(params[head + ".weight"],
                                 params[head + ".bias"], cfg.num_classes,
                                 pretrained_classes, generator)
    params["pos_embed"] = resize_pos_embed(params["pos_embed"],
                                           cfg.num_tokens,
                                           cfg.num_prefix_tokens)
    return params


def save_vit_npz(path: str, params: Mapping[str, Tensor]) -> None:
    """The port's state dict -> a flat ``.npz`` in timm keys (JAX
    ``save_vit_npz``'s interchange role), which this module's and the JAX
    package's ``load_vit_checkpoint`` both read."""
    from transformer_explainability_torch.utils.checkpoint import save_pytree
    save_pytree(path, params)


def load_npz_pytree(path: str, like: Optional[Mapping[str, Tensor]] = None
                    ) -> Dict[str, Tensor]:
    """A flat ``.npz`` state dict (JAX ``load_npz_pytree``); with ``like``,
    held to its keys and shapes."""
    from transformer_explainability_torch.utils.checkpoint import load_pytree
    return load_pytree(path, like)
