"""ImageNet-segmentation dataset (``gtsegs_ijcv.mat``).

Port of ``transformer_explainability_tpu/data/imagenet_seg.py`` (the
reference's ``data/Imagenet.py:42-81``): lazy h5py over the MATLAB
object-ref layout (``/value/img``, ``/value/gt``, with the transpose
quirks) and PIL resizing, both imported only where a file or an image is
read. Preprocessing matches the seg harness (``imagenet_seg_eval.py:
122-130``): images resized to 224 × 224 bilinear, scaled to [0, 1],
normalised with mean and std 0.5; labels resized nearest.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

MEAN = 0.5
STD = 0.5


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("resizing images needs Pillow (PIL)") from e
    return Image


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading gtsegs_ijcv.mat needs h5py") from e
    return h5py


def preprocess_image(img, size: int = 224) -> np.ndarray:
    """PIL image -> normalised (3, size, size) float32 (torchvision
    Resize + ToTensor + Normalize(0.5, 0.5))."""
    img = img.convert("RGB").resize((size, size), _pil().BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return ((x - MEAN) / STD).transpose(2, 0, 1)


def preprocess_label(lbl, size: int = 224) -> np.ndarray:
    lbl = lbl.resize((size, size), _pil().NEAREST)
    return np.asarray(lbl).astype(np.int64)


class ImagenetSegmentation:
    """Indexable (image (3, 224, 224) float32 normalised, target (224, 224)
    int64) pairs from gtsegs_ijcv.mat."""

    CLASSES = 2

    def __init__(self, path: str, size: int = 224):
        self.path = path
        self.size = size
        self._h5 = None
        with _h5py().File(path, "r") as f:
            self.length = len(f["/value/img"])

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._h5 is None:
            self._h5 = _h5py().File(self.path, "r")
        f = self._h5
        img = np.array(f[f["/value/img"][index, 0]]).transpose((2, 1, 0))
        target = np.array(f[f[f["/value/gt"][index, 0]][0, 0]]).transpose((1, 0))
        Image = _pil()
        img_p = preprocess_image(Image.fromarray(img), self.size)
        tgt_p = preprocess_label(Image.fromarray(target), self.size)
        return img_p, tgt_p


def batches(dataset, batch_size: int, limit: Optional[int] = None):
    """Stacked (images, targets) numpy batches of an indexable dataset."""
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        imgs = np.stack([it[0] for it in items])
        tgts = np.stack([it[1] for it in items])
        yield imgs, tgts
