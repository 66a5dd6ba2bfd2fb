"""Keypoint metrics: PCK / AUC / NME / EPE / multi-label accuracy.

Numerically equivalent to the reference metric stack
(reference vit_utils/top_down_eval.py:29-58 _calc_distances, :61-79
_distance_acc, :155-234 pck, :237-266 auc, :269-289 nme, :292-314 epe, :677-703 multilabel),
vectorized (no per-threshold python loops where avoidable).

The port's own copy of ``easy_vitpose_tpu/eval/metrics.py``; its heatmap
argmax is the port's ``ops/decode.py::get_max_preds`` on CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.decode import get_max_preds


def calc_distances(preds: np.ndarray, targets: np.ndarray, mask: np.ndarray,
                   normalize: np.ndarray) -> np.ndarray:
    """Normalized distances, (K, N); -1 where masked/invalid."""
    N, K, _ = preds.shape
    _mask = mask.copy().astype(bool)
    _mask[(normalize == 0).sum(1) > 0, :] = False
    normalize = normalize.astype(np.float32).copy()
    normalize[normalize <= 0] = 1e6
    d = np.linalg.norm((preds - targets) / normalize[:, None, :], axis=-1)
    out = np.where(_mask, d, -1.0).astype(np.float32)
    return out.T


def _acc_per_kpt(distances: np.ndarray, thr: float) -> np.ndarray:
    """(K, N) distances -> (K,) fraction below thr over valid, -1 if none."""
    valid = distances != -1
    nvalid = valid.sum(1)
    hits = ((distances < thr) & valid).sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = hits / nvalid
    return np.where(nvalid > 0, acc, -1.0)


def keypoint_pck_accuracy(pred, gt, mask, thr, normalize
                          ) -> Tuple[np.ndarray, float, int]:
    """Returns (per-keypoint acc (K,), avg acc, #valid keypoints)."""
    distances = calc_distances(pred, gt, mask, normalize)
    acc = _acc_per_kpt(distances, thr)
    valid = acc[acc >= 0]
    cnt = len(valid)
    return acc, (valid.mean() if cnt else 0), cnt


def pose_pck_accuracy(output, target, mask, thr: float = 0.05,
                      normalize: Optional[np.ndarray] = None):
    """PCK from heatmaps (argmax decode both sides)."""
    N, K, H, W = output.shape
    if K == 0:
        return None, 0, 0
    if normalize is None:
        normalize = np.tile(np.array([[H, W]], np.float32), (N, 1))
    pred, _ = get_max_preds(torch.from_numpy(np.asarray(output, np.float32)))
    gt, _ = get_max_preds(torch.from_numpy(np.asarray(target, np.float32)))
    return keypoint_pck_accuracy(pred.numpy(), gt.numpy(), mask,
                                 thr, normalize)


def keypoint_auc(pred, gt, mask, normalize: float, num_step: int = 20) -> float:
    nor = np.tile(np.array([[normalize, normalize]], np.float32),
                  (pred.shape[0], 1))
    distances = calc_distances(pred, gt, mask, nor)
    total = 0.0
    for i in range(num_step):
        acc = _acc_per_kpt(distances, 1.0 * i / num_step)
        valid = acc[acc >= 0]
        total += (valid.mean() if len(valid) else 0) / num_step
    return total


def keypoint_nme(pred, gt, mask, normalize_factor) -> float:
    d = calc_distances(pred, gt, mask, normalize_factor)
    v = d[d != -1]
    return v.sum() / max(1, len(v))


def keypoint_epe(pred, gt, mask) -> float:
    d = calc_distances(pred, gt, mask,
                       np.ones((pred.shape[0], pred.shape[2]), np.float32))
    v = d[d != -1]
    return v.sum() / max(1, len(v))


def multilabel_classification_accuracy(pred, gt, mask, thr: float = 0.5
                                       ) -> float:
    """Multi-label classification accuracy (reference
    top_down_eval.py:677-703): a sample counts as correct only when every
    label is on the same side of ``thr`` as its ground truth; samples
    missing any label's ground truth are excluded (mask (N,1) or (N,L))."""
    pred, gt, mask = (np.asarray(a) for a in (pred, gt, mask))
    valid = (mask > 0).min(axis=1) if mask.ndim == 2 else (mask > 0)
    pred, gt = pred[valid], gt[valid]
    if pred.shape[0] == 0:
        return 0.0
    return float((((pred - thr) * (gt - thr)) > 0).all(axis=1).mean())
