"""Saliency-map generation -> ``results.hdf5`` (the reference's
``baselines/ViT/generate_visualizations.py``).

Port of ``transformer_explainability_tpu/eval/visualize.py``, stage A of
the two-stage perturbation benchmark: explain a set of ImageNet-val-like
images on the device, upsample the maps there (bilinear × 16), min-max
normalise each map on its own (:125-131) and append them, with the
*unnormalised* images and the targets, to ``results.hdf5``, the file stage
B (:mod:`.perturbation`) reads.

    python -m transformer_explainability_torch.eval.visualize \\
        --imagenet-dir val/ --method transformer_attribution --out-dir vis
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np
import torch

from transformer_explainability_torch.data.imagenet_seg import MEAN, STD
from transformer_explainability_torch.eval.seg import (add_common_flags,
                                                       load_params, no_mesh)
from transformer_explainability_torch.explain.generator import (
    Explainer, precision_kwargs)
from transformer_explainability_torch.models.vit import (VIT_BASE_16_224,
                                                         ViTConfig)
from transformer_explainability_torch.utils.image import resize_bilinear_chw

# harness method -> (explain method, variant, start_layer)
# (reference generate_visualizations.py:70-96; 'lrp' and
# 'transformer_attribution' are the same computation)
VIS_METHODS = {
    "rollout": ("rollout_attn", "ours", 1),
    "lrp": ("transformer_attribution", "ours", 1),
    "transformer_attribution": ("transformer_attribution", "ours", 1),
    "full_lrp": ("full", "lrp", 0),
    "lrp_last_layer": ("last_layer", "lrp", 0),
    "attn_last_layer": ("last_layer_attn", "ours", 0),
    "attn_gradcam": ("attn_gradcam", "ours", 0),
}


def saliency_maps(ex: Explainer, images: np.ndarray, indices, method: str,
                  is_ablation: bool = False) -> torch.Tensor:
    """(B, 1, S, S) float32 maps on the explainer's device: the method's
    heatmap of the normalised images, upsampled and min-max normalised per
    image (the reference normalises at its batch size 1)."""
    expl_method, _, start_layer = VIS_METHODS[method]
    cfg = ex.cfg
    B, g, S = images.shape[0], cfg.grid, cfg.img_size
    norm = (np.asarray(images, np.float32) - MEAN) / STD
    heat = ex.explain(norm, indices, method=expl_method,
                      start_layer=start_layer,
                      is_ablation=is_ablation).to(torch.float32)
    if method == "full_lrp":
        res = heat.reshape(B, 1, S, S)
    else:
        res = resize_bilinear_chw(heat.reshape(B, 1, g, g), S, S)
    mn = res.amin(dim=(1, 2, 3), keepdim=True)
    mx = res.amax(dim=(1, 2, 3), keepdim=True)
    return (res - mn) / (mx - mn)


def vis_indices(vis_class: str, targets, class_id: int, B: int):
    """The class each map explains: 'top' (−1, the predicted class),
    'target' (the ground truth) or 'index' (``class_id``)."""
    if vis_class == "top":
        return np.full((B,), -1, np.int64)
    if vis_class == "target":
        return np.asarray(targets, np.int64)
    if vis_class == "index":
        return np.full((B,), class_id, np.int64)
    raise ValueError(vis_class)


def compute_saliency_and_save(data_iter: Iterable[Tuple[np.ndarray,
                                                        np.ndarray]],
                              params, out_path: str,
                              cfg: ViTConfig = VIT_BASE_16_224,
                              method: str = "transformer_attribution",
                              vis_class: str = "top",
                              class_id: int = 0,
                              is_ablation: bool = False, mesh=None,
                              precision: str = "float32",
                              device="cuda") -> int:
    """``data_iter`` yields (images (B, 3, H, W) in [0, 1] UNnormalised,
    targets (B,)); ``params`` the port's ViT state dict, explained on
    ``device``. ``vis_class``: 'top', 'target' or 'index' (reference
    ``--vis-class``, :66-68, 136-140). Batches run at
    the size they come in (JAX pads them to one compiled size). Returns the
    number of examples written."""
    from transformer_explainability_torch.data.expl_hdf5 import ResultsWriter
    no_mesh(mesh)
    _, variant, _ = VIS_METHODS[method]
    ex = Explainer(params, cfg, device, variant=variant,
                   **precision_kwargs(precision))
    n_written = 0
    with ResultsWriter(out_path, cfg.img_size) as w:
        for images, targets in data_iter:
            B = images.shape[0]
            idx = vis_indices(vis_class, targets, class_id, B)
            res = saliency_maps(ex, images, idx, method, is_ablation)
            w.append(np.asarray(images, np.float32), res.cpu().numpy(),
                     np.asarray(targets, np.int32))
            n_written += B
    return n_written


def main(argv=None):
    import argparse
    from transformer_explainability_torch.data.folder import folder_batches

    p = argparse.ArgumentParser(description="Pre-generate saliency maps")
    p.add_argument("--imagenet-dir", "--imagenet-validation-path",
                   dest="imagenet_dir", required=True,
                   help="directory of class-subdir images (ImageNet-val style)")
    # the reference parses --lmd/--cls-agn and five --no-* switches but
    # never reads them (generate_visualizations.py:115-145): accepted so
    # its command lines run unchanged, inert as upstream
    p.add_argument("--lmd", type=float, default=10, help=argparse.SUPPRESS)
    p.add_argument("--cls-agn", action="store_true", help=argparse.SUPPRESS)
    for flag in ("no-ia", "no-fx", "no-fgx", "no-m", "no-reg"):
        p.add_argument(f"--{flag}", action="store_true",
                       help=argparse.SUPPRESS)
    p.add_argument("--method", default="transformer_attribution",
                   choices=sorted(VIS_METHODS))
    p.add_argument("--vis-class", default="top",
                   choices=["top", "target", "index"])
    p.add_argument("--class-id", type=int, default=0)
    add_common_flags(p)
    p.add_argument("--is-ablation", action="store_true")
    p.add_argument("--out-dir", default="visualizations")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the explain batch over N devices (not ported "
                        "yet: ROADMAP A8)")
    p.add_argument("--precision", default="float32",
                   choices=["float32", "production", "bfloat16"],
                   help="precision preset (explain.generator."
                        "PRECISION_PRESETS, PERF.md)")
    args = p.parse_args(argv)

    no_mesh(args.mesh)
    cfg = VIT_BASE_16_224
    params = load_params(args.checkpoint, cfg, args.device)
    if args.vis_class == "index":
        method_dir = os.path.join(args.out_dir, args.method,
                                  f"{args.vis_class}_{args.class_id}")
    else:
        ablation = "ablation" if args.is_ablation else "not_ablation"
        method_dir = os.path.join(args.out_dir, args.method, args.vis_class,
                                  ablation)
    os.makedirs(method_dir, exist_ok=True)
    it = folder_batches(args.imagenet_dir, args.batch_size, cfg.img_size,
                        limit=args.limit)
    n = compute_saliency_and_save(
        it, params, os.path.join(method_dir, "results.hdf5"), cfg,
        args.method, args.vis_class, args.class_id, args.is_ablation,
        precision=args.precision, device=args.device)
    print(f"wrote {n} examples to {method_dir}/results.hdf5")


if __name__ == "__main__":
    main()
