"""Segmentation metrics in numpy: pixel accuracy, intersection / union
histograms, per-image average precision and F1, IoU, PR and ROC curves.

Port of ``transformer_explainability_tpu/utils/metrics.py`` (the
reference's ``utils/metrices.py``) without scikit-learn: average precision,
F1, the precision-recall curve and the ROC curve are written out to
scikit-learn's definitions (``average_precision_score``, ``f1_score``,
``precision_recall_curve``, ``roc_curve`` for binary labels): scores sorted
in descending order, one threshold per distinct score (tied scores share
it), true and false positives counted in float64 at each; AP is the step
sum ``-Σ Δrecall · precision``, clipped at 0. With no positive label the
recall is 1 at every threshold (AP 0); the ROC gives NaN for a class that
is absent. Binary labels are {0, 1} or {-1, 1}; others raise, as
scikit-learn's do, and so do non-finite scores.
"""

from __future__ import annotations

import numpy as np

SMOOTH = 1e-6


def batch_pix_accuracy(predict: np.ndarray, target: np.ndarray):
    """predict: (K, H, W) class scores; target: (H, W) int labels.
    Returns (pixel_correct, pixel_labeled). Reference ``metrices.py:135-151``:
    argmax over classes, +1 shift, unlabeled (<= 0 after the shift) ignored."""
    pred = predict.argmax(axis=0) + 1
    tgt = np.asarray(target) + 1
    pixel_labeled = np.sum(tgt > 0)
    pixel_correct = np.sum((pred == tgt) * (tgt > 0))
    assert pixel_correct <= pixel_labeled
    return pixel_correct, pixel_labeled


def batch_intersection_union(predict: np.ndarray, target: np.ndarray,
                             nclass: int):
    """Per-class intersection/union areas via histograms
    (reference ``metrices.py:154-177``)."""
    pred = predict.argmax(axis=0) + 1
    tgt = np.asarray(target) + 1
    pred = pred * (tgt > 0).astype(pred.dtype)
    intersection = pred * (pred == tgt)
    area_inter, _ = np.histogram(intersection, bins=nclass, range=(1, nclass))
    area_pred, _ = np.histogram(pred, bins=nclass, range=(1, nclass))
    area_lab, _ = np.histogram(tgt, bins=nclass, range=(1, nclass))
    area_union = area_pred + area_lab - area_inter
    assert (area_inter <= area_union).all()
    return area_inter, area_union


def _positives(y_true) -> np.ndarray:
    """Binary labels -> bool positives (label 1), scikit-learn's check of
    the label set with ``pos_label`` unset."""
    y_true = np.asarray(y_true).reshape(-1)
    classes = np.unique(y_true)
    if not any(len(classes) == len(ok) and (classes == ok).all()
               for ok in ([0, 1], [-1, 1], [0], [-1], [1])):
        raise ValueError(f"labels take the values {classes.tolist()}: make "
                         "them {0, 1} or {-1, 1}")
    return y_true == 1


def _clf_curve(y_true, y_score):
    """(false positives, true positives, thresholds) at each distinct score,
    in descending order of the score (scikit-learn's
    ``confusion_matrix_at_thresholds``)."""
    pos = _positives(y_true)
    y_score = np.asarray(y_score).reshape(-1)
    if pos.shape != y_score.shape:
        raise ValueError(f"{pos.shape[0]} labels for {y_score.shape[0]} "
                         "scores")
    if not np.isfinite(y_score).all():
        raise ValueError("scores must be finite")
    order = np.argsort(-y_score, kind="stable")   # ties keep their order
    y_score, pos = y_score[order], pos[order]
    idx = np.r_[np.nonzero(np.diff(y_score))[0], pos.size - 1]
    tps = np.cumsum(pos.astype(np.float64), dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), precision ending in 1 and recall in
    0, thresholds increasing (scikit-learn's, ``drop_intermediate=False``)."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) with collinear points dropped and an ``inf``
    threshold first (scikit-learn's ``roc_curve``)."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                    np.diff(tps, 2)),
                                True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def average_precision_score(y_true, y_score) -> float:
    """Binary average precision: the step sum over the PR curve."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def f1_score(y_true, y_pred) -> float:
    """Binary F1 of label 1: 2·tp / (true + predicted), 0 when both are 0."""
    pos_t = _positives(y_true)
    pos_p = _positives(y_pred)
    tp = float(np.sum(pos_t & pos_p))
    denom = float(np.sum(pos_t)) + float(np.sum(pos_p))
    return 0.0 if denom == 0 else 2.0 * tp / denom


def _onehot_rows(pred, tgt, ignore_index):
    """(K, H, W) scores and (H, W) labels -> the kept scores and their
    one-hot labels, flattened (reference ``metrices.py:61-99``)."""
    K = pred.shape[0]
    tgt_exp = np.broadcast_to(tgt[None], pred.shape).reshape(-1)
    onehot = (np.arange(K)[:, None, None] ==
              np.clip(tgt, 0, None)[None]).astype(np.float64)
    keep = tgt_exp != ignore_index
    return onehot.reshape(-1)[keep], pred.reshape(-1)[keep]


def get_ap_scores(predict: np.ndarray, target: np.ndarray,
                  ignore_index: int = -1):
    """predict: (B, K, H, W) scores; target: (B, H, W) int. Per-image AP on
    the one-hot expansion (reference ``metrices.py:81-99``)."""
    return [np.nan_to_num(average_precision_score(
        *_onehot_rows(pred, tgt, ignore_index)))
        for pred, tgt in zip(predict, target)]


def get_f1_scores(predict: np.ndarray, target: np.ndarray,
                  ignore_index: int = -1):
    """predict: binary (H, W) (or batched); target: same shape int
    (reference ``metrices.py:26-38``)."""
    predict = np.asarray(predict)
    target = np.asarray(target)
    if predict.ndim == 2:
        predict, target = predict[None], target[None]
    total = []
    for p, t in zip(predict, target):
        p, t = p.reshape(-1), t.reshape(-1)
        keep = t != ignore_index
        total.append(np.nan_to_num(f1_score(t[keep], p[keep])))
    return total


def get_iou(outputs: np.ndarray, labels: np.ndarray):
    """Boolean IoU per image, smoothed (reference ``metrices.py:11-23``)."""
    outputs = np.asarray(outputs).astype(bool)
    labels = np.asarray(labels).astype(bool)
    if outputs.ndim == 4:
        outputs = outputs.squeeze(1)
    if labels.ndim == 4:
        labels = labels.squeeze(1)
    inter = (outputs & labels).sum((1, 2)).astype(np.float64)
    union = (outputs | labels).sum((1, 2)).astype(np.float64)
    return (inter + SMOOTH) / (union + SMOOTH)


def get_pr(predict, target, ignore_index=-1):
    """Per-image precision-recall curves (reference ``metrices.py:61-78``)."""
    return [precision_recall_curve(*_onehot_rows(pred, tgt, ignore_index))
            for pred, tgt in zip(predict, target)]


def get_roc(predict, target, ignore_index=-1):
    return [roc_curve(*_onehot_rows(pred, tgt, ignore_index))
            for pred, tgt in zip(predict, target)]


def get_ap_multiclass(predict, target):
    return [np.nan_to_num(average_precision_score(t.reshape(-1),
                                                  p.reshape(-1)))
            for p, t in zip(predict, target)]


def batch_precision_recall(predict, target, thr: float = 0.5):
    """(reference ``metrices.py:113-132``)."""
    pred = (np.asarray(predict) > thr).astype(np.int64) + 1
    tgt = np.asarray(target) + 1
    tp = np.sum(((pred == 2) & (tgt == 2)) & (tgt > 0))
    fp = np.sum(((pred == 2) & (tgt == 1)) & (tgt > 0))
    fn = np.sum(((pred == 1) & (tgt == 2)) & (tgt > 0))
    precision = float(np.nan_to_num(tp / (tp + fp) if (tp + fp) else 0.0))
    recall = float(np.nan_to_num(tp / (tp + fn) if (tp + fn) else 0.0))
    return precision, recall
