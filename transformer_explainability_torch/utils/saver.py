"""Experiment-directory manager (a copy of
``transformer_explainability_tpu/utils/saver.py``, the reference's
``utils/saver.py``): ``run/<dataset>/<checkname>/experiment_N``, state
saved as ``.npz``."""

from __future__ import annotations

import glob
import os
from collections import OrderedDict

import numpy as np
import torch


class Saver:
    def __init__(self, train_dataset: str, checkname: str, root: str = "run"):
        self.directory = os.path.join(root, train_dataset, checkname)
        runs = sorted(glob.glob(os.path.join(self.directory, "experiment_*")),
                      key=lambda p: int(p.split("_")[-1]))
        run_id = int(runs[-1].split("_")[-1]) + 1 if runs else 0
        self.experiment_dir = os.path.join(self.directory,
                                           f"experiment_{run_id}")
        os.makedirs(self.experiment_dir, exist_ok=True)

    def save_checkpoint(self, state: dict, filename: str = "checkpoint.npz"):
        """``state``: names -> arrays or tensors (moved to the host)."""
        np.savez(os.path.join(self.experiment_dir, filename),
                 **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in state.items()})

    def save_experiment_config(self, params: dict):
        path = os.path.join(self.experiment_dir, "parameters.txt")
        with open(path, "w") as f:
            for k, v in OrderedDict(params).items():
                f.write(f"{k}:{v}\n")
