"""ImageFolder-style loader (class subdirectories, the torchvision ImageNet
layout the reference's ``generate_visualizations.py:200`` reads) with a
background prefetch thread.

Port of ``transformer_explainability_tpu/data/folder.py``. PIL is imported
where an image is read; normalisation goes through
:func:`..utils.image.normalize_chw` on ``device``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_folder(root: str):
    """Returns (paths, targets, class_names); classes sorted by name."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, targets = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fn in sorted(os.listdir(cdir)):
            if os.path.splitext(fn)[1].lower() in IMG_EXTS:
                paths.append(os.path.join(cdir, fn))
                targets.append(ci)
    return paths, np.asarray(targets, np.int64), classes


def _load_image_u8(path: str, size: int) -> np.ndarray:
    """-> (size, size, 3) uint8, decoded and resized bilinear."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading image files needs Pillow (PIL)") from e
    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def load_image(path: str, size: int = 224) -> np.ndarray:
    """-> (3, size, size) float32 in [0, 1] (resized bilinear, NOT
    normalised: the hdf5 contract stores unnormalised images)."""
    return (_load_image_u8(path, size).astype(np.float32)
            / 255.0).transpose(2, 0, 1)


def folder_batches(root: str, batch_size: int, size: int = 224,
                   limit: Optional[int] = None, prefetch: int = 2,
                   normalize=None) -> Iterator[Tuple[np.ndarray,
                                                     np.ndarray]]:
    """Yield (images (B, 3, S, S) float32, targets (B,)) numpy batches with
    a prefetch thread. ``normalize=None`` yields [0, 1] images (the hdf5
    contract); ``normalize=(mean, std)`` normalised ones
    (:func:`..utils.image.normalize_chw`)."""
    from transformer_explainability_torch.utils.image import normalize_chw
    paths, targets, _ = list_folder(root)
    n = len(paths) if limit is None else min(limit, len(paths))

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    DONE = object()

    def worker():
        try:
            for s in range(0, n, batch_size):
                e = min(s + batch_size, n)
                if normalize is not None:
                    u8 = np.stack([_load_image_u8(p, size)
                                   for p in paths[s:e]])
                    imgs = normalize_chw(u8, *normalize).numpy()
                else:
                    imgs = np.stack([load_image(p, size)
                                     for p in paths[s:e]])
                q.put((imgs, targets[s:e]))
            q.put(DONE)
        except BaseException as exc:       # surfaced in the consumer
            q.put(exc)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
