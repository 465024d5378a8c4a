"""Positive / negative perturbation benchmark (the reference's
``baselines/ViT/pertubation_eval_from_hdf5.py``).

Port of ``transformer_explainability_tpu/eval/perturbation.py``, stage B:
read ``results.hdf5`` (images in [0, 1], normalised heatmaps, targets); for
9 steps (10 % .. 90 % of the pixels) zero the most relevant pixels
(positive) or the least (negative: ``vis = -vis``), classify again with
the frozen ViT and record accuracy, logit and probability differences and
the log(target / second) dissimilarity per step. Each batch runs ten
forwards of the port's ``VisionTransformer`` on the device in exact FP32
(the base images and the nine perturbed sets); the pixels to zero are the
top-k of a stable descending ``torch.argsort`` of the map, cleared with
``scatter_``. The AUC over the 9-step accuracy curve (trapezoid) is the
paper's headline number (positive: lower is better; negative: higher).

    python -m transformer_explainability_torch.eval.perturbation \\
        --vis-dir vis/transformer_attribution/top/not_ablation --neg
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from transformer_explainability_torch.data.imagenet_seg import MEAN, STD
from transformer_explainability_torch.eval.seg import (add_common_flags,
                                                       load_params)
from transformer_explainability_torch.explain.generator import (
    _check_fp32_matmul, _resolve_device)
from transformer_explainability_torch.models.vit import (
    VIT_BASE_16_224, ViTConfig, VisionTransformer, forward_collect)
from transformer_explainability_torch.ops import kernels as K

PERTURB_STEPS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)

RESULT_KEYS = ("model_hits", "model_dissimilarities", "perturbations_hits",
               "perturbations_dissimilarities", "perturbations_logit_diff",
               "perturbations_prob_diff")


def make_perturb_eval_fn(cfg: ViTConfig = VIT_BASE_16_224,
                         steps=PERTURB_STEPS,
                         ops: K.AttnOps = K.KERNEL_OPS) -> Callable:
    """Build ``fn(model, images01, vis, targets) -> dict of tensors``.

    ``images01`` (B, 3, H, W) in [0, 1]; ``vis`` (B, H·W) saliency (negated
    by the caller for the negative test); ``targets`` (B,), all on the
    model's device. Outputs: ``base_correct``, ``base_dissim`` (B,) and per
    step ``pertub_correct``, ``pertub_logit_diff``, ``pertub_prob_diff``,
    ``pertub_dissim`` (9, B). The forwards are exact products in the
    model's dtype (JAX's default ``matmul_precision="float32"``; float32
    on a card needs TF32 off), the attention core in ``ops`` (the kernel,
    or for a reference run its plain version)."""
    base_size = cfg.img_size * cfg.img_size
    ks = [int(base_size * s) for s in steps]

    def classify(model, images01):
        norm = (images01 - MEAN) / STD
        return forward_collect(model, norm.to(model.cls_token.dtype),
                               ops)[0]

    def stats(logits, targets):
        probs = torch.softmax(logits, dim=-1)
        pred_logit = logits.amax(dim=-1)
        pred_prob = probs.amax(dim=-1)
        correct = (targets == logits.argmax(dim=-1)).to(torch.float32)
        tprob = probs.gather(1, targets[:, None])[:, 0]
        second = probs.topk(2, dim=-1).values[:, 1]
        return correct, pred_logit, pred_prob, torch.log(tprob / second)

    @torch.no_grad()
    def fn(model: VisionTransformer, images01, vis, targets):
        if model.cfg != cfg:
            raise ValueError("model config differs from the eval fn's")
        _check_fp32_matmul(images01.device, model.cls_token.dtype)
        B = images01.shape[0]
        b_correct, b_logit, b_prob, b_dissim = stats(
            classify(model, images01), targets)
        flat = images01.reshape(B, 3, -1)
        order = torch.argsort(vis, dim=-1, descending=True, stable=True)
        rows = []
        for k in ks:
            mask = torch.ones((B, flat.shape[-1]), dtype=images01.dtype,
                              device=images01.device)
            mask.scatter_(1, order[:, :k], 0.0)
            pert = (flat * mask[:, None, :]).reshape(images01.shape)
            c, pl, pp, d = stats(classify(model, pert), targets)
            rows.append((c, pl - b_logit, pp - b_prob, d))
        return {"base_correct": b_correct, "base_dissim": b_dissim,
                "pertub_correct": torch.stack([r[0] for r in rows]),
                "pertub_logit_diff": torch.stack([r[1] for r in rows]),
                "pertub_prob_diff": torch.stack([r[2] for r in rows]),
                "pertub_dissim": torch.stack([r[3] for r in rows])}

    return fn


def run_perturbation_eval(results_ds, params, cfg: ViTConfig = VIT_BASE_16_224,
                          neg: bool = False, batch_size: int = 16,
                          save_dir: Optional[str] = None,
                          limit: Optional[int] = None,
                          progress: bool = True, device="cuda",
                          ops: K.AttnOps = K.KERNEL_OPS
                          ) -> Dict[str, np.ndarray]:
    """``results_ds``: :class:`..data.expl_hdf5.ImagenetResults`, or any
    object with ``__len__`` and ``batches(batch_size)`` yielding (images,
    vis, targets) numpy batches; ``params`` the port's ViT state dict, run
    on ``device`` (``ops`` as :func:`make_perturb_eval_fn`'s). Returns the
    6 arrays the reference saves (:123-128), the step-accuracy curve and
    its AUC."""
    device = _resolve_device(device)
    dtype = params["cls_token"].dtype
    model = VisionTransformer(cfg, device=device, dtype=dtype)
    model.load_state_dict(params)
    model.requires_grad_(False)
    fn = make_perturb_eval_fn(cfg, ops=ops)
    acc = {k: [] for k in RESULT_KEYS}
    it = results_ds.batches(batch_size)
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(it, total=(len(results_ds) + batch_size - 1)
                      // batch_size)
        except ImportError:
            pass
    n = 0
    for images, vis, targets in it:
        if limit is not None and n >= limit:
            break
        B = images.shape[0]
        v = torch.as_tensor(np.asarray(vis), device=device).reshape(B, -1)
        out = fn(model, torch.as_tensor(np.asarray(images), device=device),
                 -v if neg else v,
                 torch.as_tensor(np.asarray(targets), device=device)
                 .to(torch.int64))
        out = {k: a.cpu().numpy() for k, a in out.items()}
        acc["model_hits"].append(out["base_correct"])
        acc["model_dissimilarities"].append(out["base_dissim"])
        acc["perturbations_hits"].append(out["pertub_correct"])
        acc["perturbations_dissimilarities"].append(out["pertub_dissim"])
        acc["perturbations_logit_diff"].append(out["pertub_logit_diff"])
        acc["perturbations_prob_diff"].append(out["pertub_prob_diff"])
        n += B

    res = {k: np.concatenate(v, axis=-1) for k, v in acc.items()}
    curve = res["perturbations_hits"].mean(axis=1)
    res["step_accuracy"] = curve
    # AUC over fraction-removed in [0.1, 0.9] (trapezoid), x100 as in paper
    res["auc"] = float(np.trapezoid(curve, PERTURB_STEPS) /
                       (PERTURB_STEPS[-1] - PERTURB_STEPS[0]) * 100)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        for k in RESULT_KEYS:
            np.save(os.path.join(save_dir, k + ".npy"), res[k])
    return res


def main(argv=None):
    import argparse
    from transformer_explainability_torch.data.expl_hdf5 import ImagenetResults

    p = argparse.ArgumentParser(description="Perturbation AUC benchmark")
    p.add_argument("--vis-dir", required=True,
                   help="directory containing results.hdf5 (stage A output)")
    p.add_argument("--neg", action="store_true",
                   help="negative perturbation (remove least relevant first)")
    add_common_flags(p)
    p.add_argument("--save-dir", default=None)
    args = p.parse_args(argv)

    cfg = VIT_BASE_16_224
    params = load_params(args.checkpoint, cfg, args.device)
    ds = ImagenetResults(args.vis_dir)
    res = run_perturbation_eval(ds, params, cfg, args.neg, args.batch_size,
                                args.save_dir, args.limit,
                                device=args.device)
    print("base accuracy:", res["model_hits"].mean())
    print("steps:", list(PERTURB_STEPS))
    print("step accuracy:", res["step_accuracy"])
    print("AUC:", res["auc"])


if __name__ == "__main__":
    main()
