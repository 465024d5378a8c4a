"""State-dict checkpointing as a flat ``.npz``.

Counterpart of ``transformer_explainability_tpu/utils/checkpoint.py``'s
``save_pytree`` / ``load_pytree`` for the port's flat state dicts: one
array per state-dict name, plain numpy archives that need no torch to read.
The train-state functions (``save_train_state`` and the others) wait for
the training paths (ROADMAP A7); the orbax backend is not ported.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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
