"""OKS (object keypoint similarity) IoU and NMS variants.

The port's own copy of ``easy_vitpose_tpu/ops/oks.py`` (numpy only).

Vectorized equivalents of the reference's python loops
(reference vit_utils/post_processing/nms.py: nms :9-48, oks_iou :51-87,
oks_nms :89-127, _rescore :130-152, soft_oks_nms :155-210).

Note on ``vis_thr``: the reference computes ``ind = list(vg > t) and
list(vd > t)`` which in python evaluates to just ``list(vd > t)`` — i.e. only
the *detected* keypoint visibility gates the OKS terms.  We reproduce that
actual behaviour for parity.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# COCO-17 default sigmas (same table as the reference's oks_iou default)
DEFAULT_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
    .87, .87, .89, .89], dtype=np.float64) / 10.0


def bbox_nms(dets: np.ndarray, thr: float) -> List[int]:
    """Greedy hard IoU NMS over [x1,y1,x2,y2,score] rows
    (reference nms.py:9-48)."""
    if len(dets) == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[np.where(ovr <= thr)[0] + 1]
    return keep


def oks_iou(g: np.ndarray, d: np.ndarray, a_g: float, a_d: np.ndarray,
            sigmas: Optional[np.ndarray] = None,
            vis_thr: Optional[float] = None) -> np.ndarray:
    """OKS between one gt pose g (K*3,) and n poses d (n, K*3); vectorized."""
    if sigmas is None:
        sigmas = DEFAULT_SIGMAS
    var = (np.asarray(sigmas) * 2) ** 2
    xg, yg = g[0::3], g[1::3]
    xd, yd, vd = d[:, 0::3], d[:, 1::3], d[:, 2::3]
    denom = ((a_g + np.asarray(a_d)) / 2 + np.spacing(1))[:, None]
    e = ((xd - xg) ** 2 + (yd - yg) ** 2) / var / denom / 2
    if vis_thr is not None:
        sel = vd > vis_thr  # reference's actual gating (see module docstring)
        cnt = sel.sum(1)
        s = np.where(sel, np.exp(-e), 0.0).sum(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ious = np.where(cnt > 0, s / cnt, 0.0)
    else:
        ious = np.exp(-e).mean(1)
    return ious.astype(np.float32)


def _extract(kpts_db: Sequence[dict], score_per_joint: bool):
    if score_per_joint:
        scores = np.array([k["score"].mean() for k in kpts_db])
    else:
        scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    return scores, kpts, areas


def oks_nms(kpts_db: Sequence[dict], thr: float,
            sigmas: Optional[np.ndarray] = None,
            vis_thr: Optional[float] = None,
            score_per_joint: bool = False) -> np.ndarray:
    """Greedy OKS NMS; returns kept indices (reference nms.py:89-127)."""
    if len(kpts_db) == 0:
        return []
    scores, kpts, areas = _extract(kpts_db, score_per_joint)
    order = scores.argsort()[::-1]
    keep = []
    while len(order) > 0:
        i = order[0]
        keep.append(i)
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, vis_thr)
        order = order[np.where(ovr <= thr)[0] + 1]
    return np.array(keep)


def soft_oks_nms(kpts_db: Sequence[dict], thr: float, max_dets: int = 20,
                 sigmas: Optional[np.ndarray] = None,
                 vis_thr: Optional[float] = None,
                 score_per_joint: bool = False) -> np.ndarray:
    """Gaussian soft OKS NMS (reference nms.py:155-210)."""
    if len(kpts_db) == 0:
        return []
    scores, kpts, areas = _extract(kpts_db, score_per_joint)
    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = []
    while len(order) > 0 and len(keep) < max_dets:
        i = order[0]
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, vis_thr)
        order = order[1:]
        scores = scores[1:] * np.exp(-ovr ** 2 / thr)
        resort = scores.argsort()[::-1]
        order = order[resort]
        scores = scores[resort]
        keep.append(i)
    return np.array(keep, dtype=np.intp)
