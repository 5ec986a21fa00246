"""Segmentation metrics (the port of zutis_tpu/engine/metrics.py).

`confusion_update` builds the [n_classes, n_classes] histogram of (gt,
pred) pairs on the tensors' device, ignoring labels outside [0, n_classes),
as an `index_add_` of ones into a zero [n_classes^2] tensor: on a card
`torch.bincount` reads its input's maximum back to the host, a sync in
every step. The counts are float32 (exact up to 2^24 per cell), as the JAX
package's weighted bincount.

RunningScore mirrors the reference confusion-matrix scorer (pixel
accuracy, mean class accuracy, mean IoU, frequency-weighted IoU) and
AverageMeter the reference meter; `compute_iou` is a binary mask IoU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def confusion_update(gt: torch.Tensor, pred: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """-> [n_classes, n_classes] float32 histogram; rows gt, columns pred."""
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < n_classes)
    idx = torch.where(valid, gt * n_classes + pred, 0)
    counts = torch.zeros(n_classes * n_classes, dtype=torch.float32,
                         device=gt.device)
    counts.index_add_(0, idx, valid.float())
    return counts.reshape(n_classes, n_classes)


class RunningScore:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes), np.float64)

    def update(self, label_trues, label_preds) -> None:
        self.confusion_matrix += confusion_update(
            torch.as_tensor(np.asarray(label_trues)),
            torch.as_tensor(np.asarray(label_preds)),
            self.n_classes,
        ).numpy()

    def reset(self) -> None:
        self.confusion_matrix[:] = 0

    def get_scores(self) -> Tuple[Dict[str, float], Dict[int, float]]:
        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (
                hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
            mean_iu = np.nanmean(iu)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        cls_iu = dict(zip(range(self.n_classes), iu))
        return ({"Pixel Acc": acc, "Mean Acc": acc_cls, "FreqW Acc": fwavacc,
                 "Mean IoU": mean_iu}, cls_iu)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def compute_iou(pred_mask: np.ndarray, gt_mask: np.ndarray,
                threshold: Optional[float] = 0.5) -> float:
    """Binary IoU with optional thresholding of the prediction."""
    if threshold is not None:
        pred_mask = pred_mask > threshold
    pred_mask = pred_mask.astype(bool)
    gt_mask = gt_mask.astype(bool)
    inter = np.logical_and(pred_mask, gt_mask).sum()
    union = np.logical_or(pred_mask, gt_mask).sum()
    return float(inter / union) if union > 0 else 0.0
