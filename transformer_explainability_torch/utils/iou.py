"""Confusion-matrix IoU metric (numpy only).

A copy of ``transformer_explainability_tpu/utils/iou.py`` (the reference's
``utils/iou.py``, ``utils/confusionmatrix.py`` and ``utils/metric.py``
collapsed into one class), kept in the port so that it imports no JAX."""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int, normalized: bool = False):
        self.num_classes = num_classes
        self.normalized = normalized
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def reset(self):
        self.conf.fill(0)

    def add(self, predicted: np.ndarray, target: np.ndarray):
        """Accepts either N integer labels or (N, K) class scores / one-hot
        rows, dispatching on ndim like the reference
        (``utils/confusionmatrix.py:48-67``)."""
        predicted = np.asarray(predicted)
        target = np.asarray(target)
        assert predicted.shape[0] == target.shape[0]
        if predicted.ndim != 1:
            assert predicted.shape[1] == self.num_classes
            predicted = predicted.argmax(1)
        if target.ndim != 1:
            assert target.shape[1] == self.num_classes
            target = target.argmax(1)
        predicted = predicted.reshape(-1)
        target = target.reshape(-1)
        mask = (target >= 0) & (target < self.num_classes)
        x = predicted[mask] + self.num_classes * target[mask]
        bincount = np.bincount(x.astype(np.int64),
                               minlength=self.num_classes ** 2)
        self.conf += bincount.reshape(self.num_classes, self.num_classes)

    def value(self):
        if self.normalized:
            conf = self.conf.astype(np.float64)
            return conf / conf.sum(1, keepdims=True).clip(min=1e-12)
        return self.conf


class IoU:
    """IoU = TP / (TP + FP + FN) accumulated in a confusion matrix
    (reference ``utils/iou.py:7-93``)."""

    def __init__(self, num_classes: int, normalized: bool = False,
                 ignore_index=None):
        self.conf_metric = ConfusionMatrix(num_classes, normalized)
        if ignore_index is None:
            self.ignore_index = None
        elif isinstance(ignore_index, int):
            self.ignore_index = (ignore_index,)
        else:
            self.ignore_index = tuple(ignore_index)

    def reset(self):
        self.conf_metric.reset()

    def add(self, predicted: np.ndarray, target: np.ndarray):
        predicted = np.asarray(predicted)
        target = np.asarray(target)
        if predicted.ndim == 4:
            predicted = predicted.argmax(1)
        if target.ndim == 4:
            target = target.argmax(1)
        self.conf_metric.add(predicted.reshape(-1), target.reshape(-1))

    def value(self):
        conf_matrix = self.conf_metric.value().astype(np.float64)
        if self.ignore_index is not None:
            for index in self.ignore_index:
                conf_matrix[:, index] = 0
                conf_matrix[index, :] = 0
        tp = np.diag(conf_matrix)
        fp = conf_matrix.sum(0) - tp
        fn = conf_matrix.sum(1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp + fn)
        return iou, np.nanmean(iou)
