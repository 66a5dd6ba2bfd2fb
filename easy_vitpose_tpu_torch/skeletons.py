"""Skeleton registry: keypoint names, bones, flip pairs and OKS sigmas.

The port's own copy of ``easy_vitpose_tpu/skeletons.py``.  Data lives in
:mod:`.skeletons_data` (extracted public dataset
taxonomy; reference joints_dict at vit_utils/visualization.py:13-355).
Flip pairs are derived from left_/right_ name symmetry rather than hard-coded
tables, so every dataset (incl. wholebody-133) gets correct flip behaviour.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from .skeletons_data import JOINTS

# COCO-17 OKS per-keypoint sigmas (public COCO eval constants, used by the
# OKS-NMS path; reference post_processing/nms.py oks_iou uses them via caller).
COCO_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072,
    .062, .062, .107, .107, .087, .087, .089, .089], dtype=np.float32)


def joints_dict() -> Dict[str, dict]:
    """Same shape as the reference API: {dataset: {'keypoints': {...}, 'skeleton': [...]}}"""
    return JOINTS


@lru_cache(maxsize=None)
def keypoint_names(dataset: str) -> Tuple[str, ...]:
    kp = JOINTS[dataset]["keypoints"]
    return tuple(kp[i] for i in range(len(kp)))


@lru_cache(maxsize=None)
def skeleton_bones(dataset: str) -> Tuple[Tuple[int, int], ...]:
    return tuple(tuple(b) for b in JOINTS[dataset]["skeleton"])


# 68-landmark (iBUG) face horizontal symmetry, used by wholebody's
# face-0..face-67 block: jawline, brows, nostrils, eyes, mouth.
_FACE68_PAIRS = (
    [(i, 16 - i) for i in range(8)]
    + [(17, 26), (18, 25), (19, 24), (20, 23), (21, 22)]
    + [(31, 35), (32, 34)]
    + [(36, 45), (37, 44), (38, 43), (39, 42), (40, 47), (41, 46)]
    + [(48, 54), (49, 53), (50, 52), (55, 59), (56, 58)]
    + [(60, 64), (61, 63), (65, 67)]
)


@lru_cache(maxsize=None)
def flip_pairs(dataset: str) -> Tuple[Tuple[int, int], ...]:
    """(left, right) index pairs derived from name symmetry.

    Matches the hand-coded COCO table used by the reference dataset
    (reference datasets/COCO.py:114) for coco and extends uniformly to all
    supported skeletons; handles the per-dataset naming conventions
    (left_/right_, L_/R_, Left*/Right*) and wholebody's face-N landmarks.
    """
    names = keypoint_names(dataset)
    index = {n: i for i, n in enumerate(names)}
    pairs: List[Tuple[int, int]] = []
    for n, i in index.items():
        for lp, rp in (("left_", "right_"), ("l_", "r_"),
                       ("L_", "R_"), ("Left", "Right")):
            if n.startswith(lp):
                r = rp + n[len(lp):]
                if r in index and (i, index[r]) not in pairs:
                    pairs.append((i, index[r]))
    if "face-0" in index:
        base = index["face-0"]
        for a, b in _FACE68_PAIRS:
            pairs.append((base + a, base + b))
    pairs.sort()
    return tuple(pairs)


def num_keypoints(dataset: str) -> int:
    return len(JOINTS[dataset]["keypoints"])
