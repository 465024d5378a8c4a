"""Heatmap rendering without matplotlib.

Port of ``transformer_explainability_tpu/utils/render.py`` (the
reference's ``utils/render.py``: ``hm_to_rgb`` with the ``bwr`` diverging
map, ``vec2im``, ``enlarge_image``, ``repaint_corner_pixels``) and of the
reference's ``save_saliency_map`` (``baselines/ViT/misc_functions.py``).
The ``jet`` and ``bwr`` colormaps are built here from matplotlib's
published segment data as its 256-entry ``LinearSegmentedColormap`` tables
(``matplotlib/_cm.py``, ``colors._create_lookup_table``) and applied as
its ``Colormap.__call__`` does, so neither the demo nor the harnesses need
matplotlib. :func:`apply_colormap` takes numpy arrays or tensors (on any
device). cv2 is imported by :func:`save_saliency_map` alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_COLORS = 256

# matplotlib's segment data: (x, y_below, y_above) per channel
_SEGMENTS = {
    "jet": {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                    (1.0, 0.5, 0.5)),
            "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1),
                      (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
            "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1),
                     (0.65, 0, 0), (1.0, 0, 0))},
    # LinearSegmentedColormap.from_list of blue, white, red
    "bwr": {"red": ((0.0, 0.0, 0.0), (0.5, 1.0, 1.0), (1.0, 1.0, 1.0)),
            "green": ((0.0, 0.0, 0.0), (0.5, 1.0, 1.0), (1.0, 0.0, 0.0)),
            "blue": ((0.0, 1.0, 1.0), (0.5, 1.0, 1.0), (1.0, 0.0, 0.0))},
}


def _lookup_table(data, N: int = N_COLORS) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` (gamma 1)."""
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (N - 1), adata[:, 1], adata[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def colormap_table(name: str) -> np.ndarray:
    """The ``(N + 3, 4)`` RGBA table of ``name`` (``"jet"`` or ``"bwr"``):
    N colours, then the under (first colour), over (last colour) and bad
    (transparent black) entries, as matplotlib's ``Colormap._lut``."""
    if name not in _SEGMENTS:
        raise ValueError(f"unknown colormap {name!r}; available: "
                         f"{sorted(_SEGMENTS)}")
    lut = np.ones((N_COLORS + 3, 4), np.float64)
    for c, ch in enumerate(("red", "green", "blue")):
        lut[:-3, c] = _lookup_table(_SEGMENTS[name][ch])
    lut[N_COLORS] = lut[0]
    lut[N_COLORS + 1] = lut[N_COLORS - 1]
    lut[N_COLORS + 2] = 0.0
    lut.setflags(write=False)
    return lut


def apply_colormap(name: str, x):
    """RGBA float64 colours of ``x`` (float values in [0, 1]; numpy array
    or tensor, on its device), as ``matplotlib.cm.<name>(x)``: ``x · N`` in
    ``x``'s dtype, 1.0 -> the last colour, truncated to an index; below 0
    the under colour, at or above N the over colour, NaN the bad one."""
    lut = colormap_table(name)
    N = N_COLORS
    if torch.is_tensor(x):
        xa = x * N
        xa = torch.where(xa == N, torch.full_like(xa, N - 1), xa)
        idx = xa.nan_to_num(0.0).clamp(-1, N).to(torch.int64)
        idx = torch.where(xa < 0, N, torch.where(xa >= N, N + 1, idx))
        idx = torch.where(torch.isnan(xa), N + 2, idx)
        return torch.tensor(lut, device=x.device)[idx]
    xa = np.array(x, copy=True)
    xa *= N
    xa[xa == N] = N - 1
    under, over, bad = xa < 0, xa >= N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = N, N + 1, N + 2
    return lut.take(idx, axis=0, mode="clip")


def vec2im(V, shape=()):
    """Reshape a vector to a 2D map (square if no shape given), reference
    ``render.py`` vec2im."""
    V = np.asarray(V)
    if V.ndim == 2 and not shape:
        return V
    if not shape:
        n = int(np.sqrt(V.size))
        shape = (n, n)
    return V.reshape(shape)


def enlarge_image(img: np.ndarray, scaling: int = 3):
    """Nearest-neighbour upscale by an integer factor."""
    if scaling < 1:
        raise ValueError("scaling factor needs to be an int >= 1")
    return img.repeat(scaling, axis=0).repeat(scaling, axis=1)


def repaint_corner_pixels(rgbimg: np.ndarray, scaling: int = 3):
    """Average out the scaling-block corners used as colour anchors."""
    rgbimg[0:scaling, 0:scaling] = (
        rgbimg[0, scaling] + rgbimg[scaling, 0] + rgbimg[scaling, scaling]) / 3.0
    rgbimg[-scaling:, -scaling:] = (
        rgbimg[-1, -1 - scaling] + rgbimg[-1 - scaling, -1]
        + rgbimg[-1 - scaling, -1 - scaling]) / 3.0
    return rgbimg


def hm_to_rgb(R, X=None, scaling: int = 3, shape=(), sigma: int = 2,
              cmap: str = "bwr", normalize: bool = True) -> np.ndarray:
    """Heatmap -> RGB image via a diverging colormap (reference
    ``render.py:153``: normalize to [-1, 1] by max |R|, shift to [0, 1],
    enlarge, colorize). ``R`` a numpy array or a tensor (read to the
    host)."""
    if torch.is_tensor(R):
        R = R.detach().cpu().numpy()
    R = vec2im(np.asarray(R, np.float64), shape)
    if normalize:
        m = np.max(np.abs(R))
        if m > 0:
            R = R / m
        R = (R + 1.0) / 2.0
    R = enlarge_image(R, scaling)
    rgb = apply_colormap(cmap, R.flatten())[..., 0:3]
    return rgb.reshape(R.shape[0], R.shape[1], 3)


def normalize_inverse(img_chw, mean, std) -> np.ndarray:
    """Undo a mean/std normalization (reference ``misc_functions.py``
    NormalizeInverse): returns the [0, 1]-range image."""
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1)
    return np.clip(np.asarray(img_chw, np.float32) * std + mean, 0.0, 1.0)


def save_saliency_map(image: np.ndarray, saliency_map: np.ndarray,
                      filename: str):
    """JET-overlay saliency save (reference ``baselines/ViT/misc_functions.py:
    37-68``): normalize both, apply cv2's JET colormap to the saliency, add.
    Needs OpenCV (``cv2``)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("save_saliency_map writes through OpenCV: it needs "
                          "the cv2 package") from e
    image = np.asarray(image, np.float32)
    saliency_map = np.asarray(saliency_map, np.float32)

    saliency_map = saliency_map - saliency_map.min()
    saliency_map = saliency_map / (saliency_map.max() + 1e-20)
    saliency_map = np.clip(saliency_map, 0, 1)

    image = image - image.min()
    image = image / (image.max() + 1e-20)

    if saliency_map.shape[:2] != image.shape[:2]:
        saliency_map = cv2.resize(saliency_map, (image.shape[1], image.shape[0]))

    color_heatmap = cv2.applyColorMap(
        np.uint8(255 * saliency_map), cv2.COLORMAP_JET)[..., ::-1] / 255.0
    img_with_heatmap = np.clip(0.5 * color_heatmap + 0.5 * image, 0, 1)
    cv2.imwrite(filename, np.uint8(255 * img_with_heatmap[..., ::-1]))
