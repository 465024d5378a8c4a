"""State-dict checkpointing as a flat ``.npz``.

Counterpart of ``transformer_explainability_tpu/utils/checkpoint.py``'s
``save_pytree`` / ``load_pytree`` for the port's flat state dicts: one
array per state-dict name, plain numpy archives that need no torch to read.
The train-state functions (JAX ``save_train_state``, ``restore_train_state``
and ``has_train_state``) write a model's state dict, a ``torch.optim``
optimizer's ``state_dict()`` flattened to one array per name
(``state.3.exp_avg``, ``state.3.step``; its ``param_groups`` as one JSON
string) and a JSON sidecar of metadata. The orbax backend is not ported:
the port's state dicts are flat.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def save_pytree(path: str, tree: Mapping[str, Tensor]) -> None:
    """A flat state dict -> ``path`` (``.npz``), keyed by its names."""
    np.savez(path, **{k: v.detach().cpu().numpy() if torch.is_tensor(v)
                      else np.asarray(v) for k, v in tree.items()})


def load_pytree(path: str, like: Optional[Mapping[str, Tensor]] = None
                ) -> Dict[str, Tensor]:
    """``path`` -> a flat state dict of CPU tensors. With ``like``, its keys
    and shapes must match and each tensor takes ``like``'s dtype and
    device."""
    with np.load(path) as f:
        data = {k: torch.from_numpy(f[k].copy()) for k in f.files}
    if like is None:
        return data
    if set(data) != set(like):
        raise KeyError(f"{path}: keys differ from the template's: missing "
                       f"{sorted(set(like) - set(data))[:4]}, extra "
                       f"{sorted(set(data) - set(like))[:4]}")
    out = {}
    for k, ref in like.items():
        if tuple(data[k].shape) != tuple(ref.shape):
            raise ValueError(f"{path}: {k} has shape {tuple(data[k].shape)}"
                             f", the template {tuple(ref.shape)}")
        out[k] = data[k].to(ref.device, ref.dtype)
    return out


def _state_dict(x) -> Dict[str, Any]:
    """A module's or an optimizer's ``state_dict()``; a mapping as it is."""
    return x.state_dict() if hasattr(x, "state_dict") else dict(x)


def _flatten_optimizer_state(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    out = {"param_groups": np.asarray(json.dumps(sd["param_groups"]))}
    for idx, st in sd["state"].items():
        for name, v in st.items():
            out[f"state.{idx}.{name}"] = (v.detach().cpu().numpy()
                                          if torch.is_tensor(v)
                                          else np.asarray(v))
    return out


def _unflatten_optimizer_state(data) -> Dict[str, Any]:
    state: Dict[int, Dict[str, Tensor]] = {}
    for key in data.files:
        if key == "param_groups":
            continue
        _, idx, name = key.split(".", 2)
        state.setdefault(int(idx), {})[name] = torch.from_numpy(
            data[key].copy())
    return {"state": dict(sorted(state.items())),
            "param_groups": json.loads(str(data["param_groups"]))}


def save_train_state(path_prefix: str, params, opt_state,
                     metadata: Optional[Dict[str, Any]] = None) -> None:
    """Model + optimizer + metadata (JAX ``save_train_state``, the
    reference's ``resume_checkpoint`` analog): ``params`` a module or a
    flat state dict, ``opt_state`` a ``torch.optim`` optimizer or its
    ``state_dict()``. Writes ``{prefix}.params.npz``, ``{prefix}.opt.npz``
    and ``{prefix}.meta.json``."""
    save_pytree(path_prefix + ".params.npz", _state_dict(params))
    np.savez(path_prefix + ".opt.npz",
             **_flatten_optimizer_state(_state_dict(opt_state)))
    with open(path_prefix + ".meta.json", "w") as f:
        json.dump(metadata or {}, f)


def restore_train_state(path_prefix: str, params_like, opt_state_like=None
                        ) -> Tuple[Dict[str, Tensor], Dict[str, Any],
                                   Dict[str, Any]]:
    """``(params, opt_state, metadata)`` written by :func:`save_train_state`:
    the state dict in ``params_like``'s keys, shapes, dtypes and devices (a
    module or a state dict), and an optimizer state dict for
    ``load_state_dict`` (its tensors on the host; the optimizer moves
    them). With ``opt_state_like`` (an optimizer or its state dict), its
    parameter groups must hold the same parameters."""
    params = load_pytree(path_prefix + ".params.npz", _state_dict(params_like))
    with np.load(path_prefix + ".opt.npz") as f:
        opt_state = _unflatten_optimizer_state(f)
    if opt_state_like is not None:
        like = _state_dict(opt_state_like)["param_groups"]
        if [g["params"] for g in like] != [g["params"] for g in
                                           opt_state["param_groups"]]:
            raise ValueError(f"{path_prefix}.opt.npz: parameter groups "
                             "differ from the template's")
    meta_path = path_prefix + ".meta.json"
    metadata = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return params, opt_state, metadata


def has_train_state(path_prefix: str) -> bool:
    return os.path.exists(path_prefix + ".params.npz")
