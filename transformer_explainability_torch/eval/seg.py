"""ImageNet-segmentation evaluation harness (the reference's
``baselines/ViT/imagenet_seg_eval.py``).

Port of ``transformer_explainability_tpu/eval/seg.py``: each batch is
explained on the device (the port runs any batch size as it is, so the
ragged last batch needs no padding), the heatmaps are upsampled there
(bilinear × 16, :func:`upsample_bilinear`), and the post-processing (min-max
normalise, mean threshold, NaN scrub; reference :212-230) and the metrics
(pixAcc, mIoU, mAP, mF1 and the final PR curve) run in numpy on the host,
as in the JAX package, without scikit-learn (:mod:`..utils.metrics`).

    python -m transformer_explainability_torch.eval.seg \\
        --imagenet-seg-path gtsegs_ijcv.mat --checkpoint vit.pth \\
        --method transformer_attribution --precision production
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from transformer_explainability_torch.explain.generator import (
    Explainer, precision_kwargs)
from transformer_explainability_torch.models.vit import (VIT_BASE_16_224,
                                                         ViTConfig)
from transformer_explainability_torch.utils import metrics as M
from transformer_explainability_torch.utils.image import resize_bilinear_chw

# harness method name -> (explain method, rule variant, start_layer)
# (reference imagenet_seg_eval.py:186-210: transformer_attribution uses the
# "ours" model with start_layer=1; full/partial-LRP baselines use the
# orig-LRP model == variant "lrp"; rollout/gradcam use raw attention.)
SEG_METHODS = {
    "rollout": ("rollout_attn", "ours", 1),
    "full_lrp": ("full", "lrp", 0),
    "transformer_attribution": ("transformer_attribution", "ours", 1),
    "lrp_last_layer": ("last_layer", "lrp", 0),
    "attn_last_layer": ("last_layer_attn", "lrp", 0),
    "attn_gradcam": ("attn_gradcam", "ours", 0),
}


def no_mesh(mesh) -> None:
    """The harnesses' ``mesh`` option: data parallelism is not ported."""
    if mesh:
        raise NotImplementedError(
            "sharding the explain batch over devices (mesh) is not ported "
            "yet (ROADMAP A8, data parallelism)")


def upsample_bilinear(x, size: int = 224) -> torch.Tensor:
    """(B, h, w) -> (B, size, size) float32 on ``x``'s device, torch
    ``align_corners=False`` semantics."""
    x = torch.as_tensor(x).to(torch.float32)
    return resize_bilinear_chw(x[:, None], size, size)[:, 0]


def postprocess(res: np.ndarray, thr: float = 0.0):
    """Normalize + threshold one heatmap (H, W); returns
    (Res, Res_1, Res_0, Res_1_AP, Res_0_AP, pred_flat) as in the reference."""
    res = (res - res.min()) / (res.max() - res.min())
    ret = res.mean()
    res_1 = (res > ret).astype(np.float32)
    res_0 = (res <= ret).astype(np.float32)
    res_1_ap = res.copy()
    res_0_ap = 1 - res
    for a in (res_1, res_0, res_1_ap, res_0_ap):
        a[np.isnan(a)] = 0
    pred = np.clip(res, thr, None) / max(res.max(), 1e-30)
    return res, res_1, res_0, res_1_ap, res_0_ap, pred.reshape(-1)


def run_seg_eval(dataset, params, cfg: ViTConfig = VIT_BASE_16_224,
                 method: str = "transformer_attribution",
                 batch_size: int = 16, thr: float = 0.0,
                 is_ablation: bool = False, limit: Optional[int] = None,
                 save_dir: Optional[str] = None,
                 explain_fn=None, progress: bool = True,
                 save_images: int = 0, mesh=None,
                 precision: str = "float32",
                 device="cuda") -> Dict[str, float]:
    """Evaluate a heatmap method against the ImageNet-seg ground truth.

    ``dataset`` indexes (normalised image (3, S, S), label (S, S)) pairs;
    ``params`` is the port's ViT state dict, explained on ``device``;
    ``explain_fn(model, images, indices)`` may replace the explainer's
    call; ``precision`` is a preset of
    :data:`..explain.generator.PRECISION_PRESETS` (one the port does not
    run for the method raises ``NotImplementedError``). Returns {pixAcc,
    mIoU, mAP, mF1} as the reference prints them; with ``save_dir`` also
    writes ``precision.npy``, ``recall.npy`` and the result file."""
    from transformer_explainability_torch.data.imagenet_seg import batches

    no_mesh(mesh)
    expl_method, variant, start_layer = SEG_METHODS[method]
    ex = Explainer(params, cfg, device, variant=variant,
                   **precision_kwargs(precision))
    if explain_fn is None:
        def explain_fn(model, imgs, idx):
            return ex.explain(imgs, idx, method=expl_method,
                              start_layer=start_layer,
                              is_ablation=is_ablation)

    total_inter = np.zeros(2, np.int64)
    total_union = np.zeros(2, np.int64)
    total_correct = np.int64(0)
    total_label = np.int64(0)
    total_ap, total_f1 = [], []
    predictions, targets = [], []

    it = batches(dataset, batch_size, limit)
    if progress:
        try:
            from tqdm import tqdm
            n = len(dataset) if limit is None else min(limit, len(dataset))
            it = tqdm(it, total=(n + batch_size - 1) // batch_size)
        except ImportError:
            pass

    g, S = cfg.grid, cfg.img_size
    n_saved = 0
    for imgs, labels in it:
        B = imgs.shape[0]
        idx = torch.full((B,), -1, dtype=torch.int64)     # predicted class
        heat = explain_fn(ex.model, imgs, idx).to(torch.float32)
        if method == "full_lrp":
            maps = heat.reshape(B, S, S)
        else:
            maps = upsample_bilinear(heat.reshape(B, g, g), S)
        maps = maps.cpu().numpy()

        if save_dir and n_saved < save_images:
            # heatmap renderings like the reference's per-image dumps
            # (imagenet_seg_eval.py:232-260, hm_to_rgb + mask images)
            from transformer_explainability_torch.utils import render as RD
            try:
                from PIL import Image as PILImage
            except ImportError as e:
                raise ImportError("save_images writes PNGs with Pillow "
                                  "(PIL)") from e
            img_dir = os.path.join(save_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            for b in range(min(B, save_images - n_saved)):
                rgb = RD.hm_to_rgb(maps[b], scaling=1)
                PILImage.fromarray(
                    (rgb * 255).astype(np.uint8)).save(
                        os.path.join(img_dir, f"heatmap_{n_saved + b}.png"))
            n_saved += min(B, save_images - n_saved)

        for b in range(B):
            res, r1, r0, r1ap, r0ap, pred = postprocess(maps[b], thr)
            label = labels[b]
            output = np.stack([r0, r1])            # (2, H, W)
            output_ap = np.stack([r0ap, r1ap])
            correct, labeled = M.batch_pix_accuracy(output, label)
            inter, union = M.batch_intersection_union(output, label, 2)
            total_correct += np.int64(correct)
            total_label += np.int64(labeled)
            total_inter += inter.astype(np.int64)
            total_union += union.astype(np.int64)
            total_ap.append(M.get_ap_scores(output_ap[None], label[None])[0])
            total_f1.append(M.get_f1_scores(r1, label)[0])
            predictions.append(pred)
            targets.append(label.reshape(-1))

    pixAcc = float(total_correct / (np.spacing(1, dtype=np.float64)
                                    + total_label))
    iou = total_inter / (np.spacing(1, dtype=np.float64) + total_union)
    results = {
        "pixAcc": pixAcc,
        "mIoU": float(iou.mean()),
        "mAP": float(np.mean(total_ap)),
        "mF1": float(np.mean(total_f1)),
    }

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        pr, rc, _ = M.precision_recall_curve(np.concatenate(targets),
                                             np.concatenate(predictions))
        np.save(os.path.join(save_dir, "precision.npy"), pr)
        np.save(os.path.join(save_dir, "recall.npy"), rc)
        with open(os.path.join(save_dir,
                               f"result_mIoU_{results['mIoU']:.4f}.txt"),
                  "w") as f:
            f.write("Mean IoU over %d classes: %.4f\n" % (2, results["mIoU"]))
            f.write("Pixel-wise Accuracy: %2.2f%%\n" % (pixAcc * 100))
            f.write("Mean AP over %d classes: %.4f\n" % (2, results["mAP"]))
            f.write("Mean F1 over %d classes: %.4f\n" % (2, results["mF1"]))
    return results


def load_params(checkpoint: Optional[str], cfg: ViTConfig, device):
    """The harnesses' weights: ``checkpoint`` (``load_vit_checkpoint``), or
    random ones from ``init_params`` seeded 0 on ``device``, with a
    warning."""
    from transformer_explainability_torch.explain.generator import (
        _resolve_device)
    from transformer_explainability_torch.models.vit import init_params
    from transformer_explainability_torch.params.convert import (
        load_vit_checkpoint)
    device = _resolve_device(device)
    if checkpoint:
        return load_vit_checkpoint(checkpoint, cfg)
    print("WARNING: no checkpoint given — using random weights")
    return init_params(cfg, generator=torch.Generator(device=device)
                       .manual_seed(0), device=device)


def add_common_flags(p, batch_size: int = 16) -> None:
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--checkpoint", default=None,
                   help=".pth/.npz ViT-B/16 checkpoint (random init if unset)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to explain on (default: the card)")


def main(argv=None):
    import argparse
    from transformer_explainability_torch.data.imagenet_seg import (
        ImagenetSegmentation)

    p = argparse.ArgumentParser(description="ImageNet segmentation eval")
    p.add_argument("--imagenet-seg-path", required=True,
                   help="path to gtsegs_ijcv.mat")
    p.add_argument("--method", default="transformer_attribution",
                   choices=sorted(SEG_METHODS))
    add_common_flags(p)
    p.add_argument("--thr", type=float, default=0.0)
    p.add_argument("--is-ablation", action="store_true")
    p.add_argument("--save-dir", default="run/imagenet_seg")
    p.add_argument("--save-images", type=int, default=0,
                   help="save the first N heatmap renderings")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the explain batch over N devices (not ported "
                        "yet: ROADMAP A8)")
    p.add_argument("--precision", default="float32",
                   choices=["float32", "production", "bfloat16"],
                   help="precision preset: float32 = exact FP32; production "
                        "= the block megakernels (PERF.md); bfloat16 = one "
                        "bf16 pass per product")
    args = p.parse_args(argv)

    no_mesh(args.mesh)
    cfg = VIT_BASE_16_224
    params = load_params(args.checkpoint, cfg, args.device)
    ds = ImagenetSegmentation(args.imagenet_seg_path)
    results = run_seg_eval(ds, params, cfg, args.method, args.batch_size,
                           args.thr, args.is_ablation, args.limit,
                           os.path.join(args.save_dir, args.method),
                           save_images=args.save_images,
                           precision=args.precision, device=args.device)
    print("Mean IoU over 2 classes: %.4f" % results["mIoU"])
    print("Pixel-wise Accuracy: %2.2f%%" % (results["pixAcc"] * 100))
    print("Mean AP over 2 classes: %.4f" % results["mAP"])
    print("Mean F1 over 2 classes: %.4f" % results["mF1"])


if __name__ == "__main__":
    main()
