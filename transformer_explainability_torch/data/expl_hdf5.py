"""``results.hdf5``: the file between saliency generation and the
perturbation benchmark.

Port of ``transformer_explainability_tpu/data/expl_hdf5.py`` (the
reference's ``dataset/expl_hdf5.py`` reader and
``generate_visualizations.py:29-54`` writer), the same schema: ``vis``
(N, 1, S, S) float32, ``image`` (N, 3, S, S) float32 *unnormalised* in
[0, 1], ``target`` (N,) int32, all gzip. h5py is imported when a file is
opened.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("results.hdf5 is read and written with h5py") from e
    return h5py


class ImagenetResults:
    """Lazy reader of results.hdf5 -> (image, vis, target) batches."""

    def __init__(self, path: str):
        self.path = (path if path.endswith(".hdf5")
                     else os.path.join(path, "results.hdf5"))
        self._h5 = None
        with _h5py().File(self.path, "r") as f:
            self.length = len(f["/image"])

    def __len__(self):
        return self.length

    def __getitem__(self, item) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._h5 is None:
            self._h5 = _h5py().File(self.path, "r")
        d = self._h5
        return (np.asarray(d["image"][item]), np.asarray(d["vis"][item]),
                np.asarray(d["target"][item]).astype(np.int64))

    def batches(self, batch_size: int):
        for s in range(0, self.length, batch_size):
            e = min(s + batch_size, self.length)
            yield self[s:e]


class ResultsWriter:
    """Appendable writer with the reference's schema (gzip, maxshape=None)."""

    def __init__(self, path: str, img_size: int = 224):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = _h5py().File(path, "a")
        s = img_size
        if "vis" not in self.f:
            self.vis = self.f.create_dataset(
                "vis", (0, 1, s, s), maxshape=(None, 1, s, s),
                dtype=np.float32, compression="gzip")
            self.image = self.f.create_dataset(
                "image", (0, 3, s, s), maxshape=(None, 3, s, s),
                dtype=np.float32, compression="gzip")
            self.target = self.f.create_dataset(
                "target", (0,), maxshape=(None,),
                dtype=np.int32, compression="gzip")
        else:
            self.vis, self.image, self.target = (
                self.f["vis"], self.f["image"], self.f["target"])

    def append(self, images: np.ndarray, vis: np.ndarray,
               targets: np.ndarray):
        n = images.shape[0]
        for ds, arr in ((self.vis, vis), (self.image, images),
                        (self.target, targets)):
            ds.resize(ds.shape[0] + n, axis=0)
            ds[-n:] = arr

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
