"""Streaming segmentation metrics — the PyTorch counterpart of
``afan/eval/seg_miou.py`` (port of `Segmentation/metrics/stream_metrics.py`):
a running confusion matrix with Overall Acc, Mean Acc, FreqW Acc, Mean IoU
and per-class IoU. Each batch's matrix is formed on the card
(:func:`confusion_matrix`), so that one (C, C) matrix crosses to the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class StreamSegMetrics:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes),
                                         dtype=np.int64)

    def update(self, label_trues, label_preds) -> None:
        """Add the confusion of each pair of ground-truth and predicted
        label maps (numpy, any shape; labels outside ``[0, n_classes)`` are
        left out), as ``afan``'s `seg_miou.py:22-25`."""
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._fast_hist(np.asarray(lt).flatten(),
                                                     np.asarray(lp).flatten())

    def _fast_hist(self, label_true: np.ndarray, label_pred: np.ndarray
                   ) -> np.ndarray:
        mask = (label_true >= 0) & (label_true < self.n_classes)
        return np.bincount(
            self.n_classes * label_true[mask].astype(int) + label_pred[mask],
            minlength=self.n_classes ** 2,
        ).reshape(self.n_classes, self.n_classes)

    def update_hist(self, hist) -> None:
        """Add a precomputed confusion matrix."""
        self.confusion_matrix += np.asarray(hist, dtype=np.int64)

    def get_results(self) -> Dict:
        """The reference's math, NaN semantics included: a class absent
        from both ground truth and predictions gives 0/0 = NaN, which
        ``np.nanmean`` leaves out of Mean IoU and Mean Acc; a stream whose
        every pixel is ignored gives NaN Overall Acc and 0.0 FreqW Acc."""
        hist = self.confusion_matrix.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (
                hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
            mean_iu = np.nanmean(iu)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        return {
            "Overall Acc": float(acc),
            "Mean Acc": float(acc_cls),
            "FreqW Acc": float(fwavacc),
            "Mean IoU": float(mean_iu),
            "Class IoU": dict(zip(range(self.n_classes), iu)),
        }

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes),
                                         dtype=np.int64)

    @staticmethod
    def to_str(results: Dict) -> str:
        string = "\n"
        for k, v in results.items():
            if k != "Class IoU":
                string += f"{k}: {v:f}\n"
        return string


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix of one batch on the tensors' device;
    labels outside ``[0, n_classes)`` (the ignore index 255) are left
    out."""
    lt = labels.reshape(-1).long()
    lp = preds.reshape(-1).long()
    mask = (lt >= 0) & (lt < n_classes)
    idx = torch.where(mask, n_classes * lt + lp,
                      torch.full_like(lt, n_classes * n_classes))
    hist = torch.bincount(idx, minlength=n_classes * n_classes + 1)
    return hist[:-1].reshape(n_classes, n_classes)
