"""Drawing utilities: keypoints, skeletons, bboxes.

Same rendering capability as the reference (vit_utils/visualization.py:360-481
draw_points / draw_skeleton / draw_points_and_skeleton and
vit_utils/inference.py:19-38 draw_bboxes), with palette sampling via
matplotlib colormaps when available and a built-in fallback otherwise.
Operates on BGR uint8 images (cv2 convention) like the reference.

The port's own copy of ``easy_vitpose_tpu/utils/visualization.py``; cv2 and
matplotlib are optional imports (drawing needs cv2).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is expected in this image
    cv2 = None


def _palette_bgr(name: str, n: int) -> list:
    """Colormap -> list of BGR uint8 colors, EXACTLY as the reference
    extracts them (vit_utils/visualization.py:380-387, 427-434): listed
    colormaps contribute ALL their ``.colors`` (``n`` is ignored, like the
    reference's AttributeError-guarded first branch); continuous ones are
    sampled at ``linspace(0, 1, n)``; both ``np.round``-ed to uint8 and
    channel-reversed to BGR."""
    try:
        import matplotlib.pyplot as plt
        cmap = plt.get_cmap(name)
        if hasattr(cmap, "colors"):
            return np.round(np.array(cmap.colors) * 255) \
                     .astype(np.uint8)[:, ::-1].tolist()
        return np.round(np.array(cmap(np.linspace(0, 1, n))) * 255) \
                 .astype(np.uint8)[:, -2::-1].tolist()
    except Exception:
        # HSV wheel fallback (matplotlib-less environments)
        hs = np.linspace(0, 179, n, endpoint=False).astype(np.uint8)
        hsv = np.stack([hs, np.full(n, 255, np.uint8),
                        np.full(n, 255, np.uint8)], -1)[None]
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0].tolist()


def draw_points(img: np.ndarray, points: np.ndarray, person_index: int = 0,
                points_color_palette: str = "tab20",
                points_palette_samples: int = 16,
                confidence_threshold: float = 0.5) -> np.ndarray:
    """points: (K, 3) rows (y, x, score).  Pixel-exact twin of the
    reference's draw_points (vit_utils/visualization.py:360-397):
    truncated int centers, ``min(H, W) // 150`` radius, color i mod the
    extracted palette length."""
    colors = _palette_bgr(points_color_palette, points_palette_samples)
    circle_size = max(1, min(img.shape[:2]) // 150)
    for i, (y, x, s) in enumerate(points):
        if s <= confidence_threshold:
            continue
        cv2.circle(img, (int(x), int(y)), circle_size,
                   tuple(colors[i % len(colors)]), -1)
    return img


def draw_skeleton(img: np.ndarray, points: np.ndarray,
                  skeleton: Sequence[Sequence[int]], person_index: int = 0,
                  skeleton_color_palette: str = "Set2",
                  skeleton_palette_samples: int = 8,
                  confidence_threshold: float = 0.5) -> np.ndarray:
    """Pixel-exact twin of the reference's draw_skeleton
    (vit_utils/visualization.py:399-442); the bounds guard on joint
    indices is extra robustness the reference lacks."""
    colors = _palette_bgr(skeleton_color_palette, skeleton_palette_samples)
    color = tuple(colors[person_index % len(colors)])
    for (a, b) in skeleton:
        if a >= len(points) or b >= len(points):
            continue
        ya, xa, sa = points[a]
        yb, xb, sb = points[b]
        if sa <= confidence_threshold or sb <= confidence_threshold:
            continue
        cv2.line(img, (int(xa), int(ya)), (int(xb), int(yb)), color, 2)
    return img


def draw_points_and_skeleton(img: np.ndarray, points: np.ndarray,
                             skeleton: Sequence[Sequence[int]],
                             person_index: int = 0,
                             points_color_palette: str = "tab20",
                             skeleton_color_palette: str = "Set2",
                             points_palette_samples: int = 16,
                             skeleton_palette_samples: int = 8,
                             confidence_threshold: float = 0.5) -> np.ndarray:
    img = draw_skeleton(img, points, skeleton, person_index,
                        skeleton_color_palette, skeleton_palette_samples,
                        confidence_threshold)
    img = draw_points(img, points, person_index, points_color_palette,
                      points_palette_samples, confidence_threshold)
    return img


def draw_bboxes(image: np.ndarray, bounding_boxes: Iterable,
                boxes_id: Iterable, scores: Iterable) -> np.ndarray:
    """Labelled track boxes (reference vit_utils/inference.py:19-38 look)."""
    img = image.copy()
    for bbox, bid, score in zip(bounding_boxes, boxes_id, scores):
        x1, y1, x2, y2 = (int(v) for v in bbox)
        cv2.rectangle(img, (x1, y1), (x2, y2), (128, 128, 0), 2)
        label = f"#{bid}: {score:.2f}"
        (lw, lh), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ly = y1 - 5 if y1 > 20 else y1 + 20
        cv2.rectangle(img, (x1, ly - lh - 5), (x1 + lw, ly + 5),
                      (128, 128, 0), cv2.FILLED)
        cv2.putText(img, label, (x1, ly), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 0, 0), 1)
    return img
