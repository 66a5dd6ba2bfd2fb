"""COCO keypoint AP evaluation (OKS-based), pycocotools-free.

The port's own copy of ``easy_vitpose_tpu/eval/cocoeval.py`` (numpy only).

The reference delegates to pycocotools.COCOeval (reference
evaluation_on_coco.py:76-87); that package is not available in this image, so
this is a from-spec implementation of the COCO keypoint evaluation protocol:

* OKS between a gt and a detection: sum(exp(-d^2 / (2 s^2 k^2))) over labeled
  gt keypoints / count, with s^2 = gt area; crowd/unlabeled gts are 'ignore'.
* per image: detections sorted by score, greedily matched to the best
  still-unmatched gt with OKS >= threshold (ignored gts matchable only after
  real ones, without consuming precision).
* accumulate: PR curve over 101 recall points, OKS thresholds .50:.05:.95,
  area ranges all/medium/large, maxDets=20.
* summarize: AP, AP@.5, AP@.75, AP-medium, AP-large, AR (+.5/.75/m/l).

Held equal to the JAX package's copy in tests/test_torch_train_dataset.py.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from ..ops.oks import DEFAULT_SIGMAS

OKS_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e5 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e5 ** 2),
}
MAX_DETS = 20


def compute_oks(gt_kpts: np.ndarray, gt_area: float, dt_kpts: np.ndarray,
                gt_bbox: Optional[np.ndarray] = None,
                sigmas: np.ndarray = DEFAULT_SIGMAS) -> np.ndarray:
    """OKS of one gt (K,3) against n dts (n, K, 3)."""
    var = (sigmas * 2) ** 2
    vg = gt_kpts[:, 2]
    k1 = int((vg > 0).sum())
    xd, yd = dt_kpts[..., 0], dt_kpts[..., 1]
    if k1 > 0:
        dx = xd - gt_kpts[:, 0]
        dy = yd - gt_kpts[:, 1]
    else:
        # no labeled keypoints: measure distance to the expanded gt bbox
        if gt_bbox is None:
            return np.zeros(len(dt_kpts), np.float64)
        x0, y0 = gt_bbox[0] - gt_bbox[2], gt_bbox[1] - gt_bbox[3]
        x1, y1 = gt_bbox[0] + gt_bbox[2] * 2, gt_bbox[1] + gt_bbox[3] * 2
        z = np.zeros_like(xd)
        dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
        dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
    e = (dx ** 2 + dy ** 2) / var / (gt_area + np.spacing(1)) / 2
    if k1 > 0:
        e = e[:, vg > 0]
    return np.exp(-e).sum(axis=1) / e.shape[1]


class CocoKeypointEval:
    """Evaluate keypoint detections against COCO-format ground truth."""

    def __init__(self, gt: dict, results: Sequence[dict],
                 sigmas: np.ndarray = DEFAULT_SIGMAS, category_id: int = 1):
        """gt: loaded COCO annotation dict; results: list of
        {image_id, category_id, keypoints (flat K*3), score}."""
        self.sigmas = np.asarray(sigmas, np.float64)
        self.cat = category_id
        self.gts = defaultdict(list)
        for ann in gt.get("annotations", []):
            if ann.get("category_id", 1) != category_id:
                continue
            a = dict(ann)
            a["ignore"] = bool(ann.get("iscrowd", 0)) or \
                ann.get("num_keypoints", 0) == 0
            self.gts[ann["image_id"]].append(a)
        self.dts = defaultdict(list)
        for r in results:
            if r.get("category_id", 1) != category_id:
                continue
            self.dts[r["image_id"]].append(r)
        self.img_ids = sorted(set(self.gts) | set(self.dts))

    def _evaluate_img(self, img_id, area_rng, thrs):
        gts = self.gts.get(img_id, [])
        dts = sorted(self.dts.get(img_id, []),
                     key=lambda d: -d["score"])[:MAX_DETS]
        if not gts and not dts:
            return None
        gt_ignore = []
        for g in gts:
            # pycocotools: ignore iff area < lo or area > hi — BOTH range
            # ends inclusive (area == 96^2 counts as medium AND large)
            a = g.get("area", 0)
            ig = g["ignore"] or a < area_rng[0] or a > area_rng[1]
            gt_ignore.append(ig)
        # sort gts: non-ignored first (COCOeval convention)
        order = np.argsort([int(i) for i in gt_ignore], kind="stable")
        gts = [gts[i] for i in order]
        gt_ignore = np.array([gt_ignore[i] for i in order], bool)

        # OKS matrix (D, G)
        D, G = len(dts), len(gts)
        ious = np.zeros((D, G))
        if D and G:
            dt_k = np.array([np.asarray(d["keypoints"], np.float64)
                             .reshape(-1, 3) for d in dts])
            for j, g in enumerate(gts):
                gk = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
                ious[:, j] = compute_oks(
                    gk, g.get("area", 0), dt_k,
                    np.asarray(g.get("bbox", [0, 0, 0, 0]), np.float64),
                    self.sigmas)

        T = len(thrs)
        dt_match = np.zeros((T, D), dtype=np.int64)
        dt_ig = np.zeros((T, D), bool)
        gt_match = np.zeros((T, G), dtype=np.int64)
        for ti, t in enumerate(thrs):
            for di in range(D):
                best, bi = min(t, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_match[ti, gi] and not gts[gi].get("iscrowd", 0):
                        continue
                    # moving to ignored gts after a real match candidate: stop
                    if bi > -1 and not gt_ignore[bi] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best, bi = ious[di, gi], gi
                if bi == -1:
                    continue
                dt_ig[ti, di] = gt_ignore[bi]
                dt_match[ti, di] = bi + 1   # 1-based gt index; 0 = unmatched
                gt_match[ti, bi] = di + 1
        # unmatched dts falling outside the area range are ignored too
        dt_areas = np.array(
            [d.get("area", _kpt_area(d)) for d in dts]) if D else np.zeros(0)
        out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
        dt_ig = dt_ig | ((dt_match == 0) & out_of_rng[None, :])
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_match": dt_match, "dt_ignore": dt_ig,
            "num_gt": int((~gt_ignore).sum()),
        }

    def accumulate(self) -> Dict[str, float]:
        stats = {}
        for rng_name, rng in AREA_RNGS.items():
            evals = [self._evaluate_img(i, rng, OKS_THRS)
                     for i in self.img_ids]
            evals = [e for e in evals if e is not None]
            T = len(OKS_THRS)
            precisions = -np.ones((T, len(REC_THRS)))
            recalls = -np.ones(T)
            if evals:
                scores = np.concatenate([e["dt_scores"] for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                matches = np.concatenate([e["dt_match"] for e in evals],
                                         axis=1)[:, order]
                ignores = np.concatenate([e["dt_ignore"] for e in evals],
                                         axis=1)[:, order]
                n_gt = sum(e["num_gt"] for e in evals)
                if n_gt > 0:
                    tps = (matches > 0) & ~ignores
                    fps = (matches == 0) & ~ignores
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recalls[ti] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone non-increasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precisions[ti] = q
            valid = precisions > -1
            stats[f"AP_{rng_name}"] = (precisions[valid].mean()
                                       if valid.any() else -1.0)
            vr = recalls > -1
            stats[f"AR_{rng_name}"] = recalls[vr].mean() if vr.any() else -1.0
            if rng_name == "all":
                for ti, t in enumerate(OKS_THRS):
                    if t in (0.5, 0.75):
                        v = precisions[ti][precisions[ti] > -1]
                        stats[f"AP_{t}"] = v.mean() if len(v) else -1.0
                        stats[f"AR_{t}"] = (recalls[ti]
                                            if recalls[ti] > -1 else -1.0)
        return {
            "AP": stats["AP_all"], "AP .5": stats.get("AP_0.5", -1),
            "AP .75": stats.get("AP_0.75", -1),
            "AP (M)": stats["AP_medium"], "AP (L)": stats["AP_large"],
            "AR": stats["AR_all"], "AR .5": stats.get("AR_0.5", -1),
            "AR .75": stats.get("AR_0.75", -1),
            "AR (M)": stats["AR_medium"], "AR (L)": stats["AR_large"],
        }

    def summarize(self) -> Dict[str, float]:
        stats = self.accumulate()
        for k, v in stats.items():
            print(f" {k:8s} = {v:.3f}")
        return stats


def _kpt_area(det: dict) -> float:
    """Detection area the way pycocotools loadRes computes it for keypoint
    results: bbox extent over ALL keypoints (no visibility filter, no
    floor)."""
    k = np.asarray(det["keypoints"], np.float64).reshape(-1, 3)
    x, y = k[:, 0], k[:, 1]
    return float((x.max() - x.min()) * (y.max() - y.min()))


def evaluate_results_file(gt_path: str, results_path: str,
                          sigmas=DEFAULT_SIGMAS) -> Dict[str, float]:
    with open(gt_path) as f:
        gt = json.load(f)
    with open(results_path) as f:
        results = json.load(f)
    return CocoKeypointEval(gt, results, sigmas=sigmas).summarize()
