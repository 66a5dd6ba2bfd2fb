"""Bottom-up associative-embedding grouping (port of ``easy_vitpose_tpu/ops/group.py``).

The reference's HeatmapParser (vit_utils/post_processing/group.py:13-169),
which no main path calls: max-pool peak NMS over per-joint heatmaps,
per-joint top-k candidates, and the assembly of candidates into people by
tag distance.  Peak NMS and top-k are torch on the maps' device; the
joint-by-joint assignment is host numpy with scipy's Hungarian solver, as
in JAX's (the reference uses Munkres).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def heatmap_peak_nms(heatmaps: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Keep the values equal to their ``kernel`` x ``kernel`` max-pool (the
    window padded with -inf, as ``lax.reduce_window``), zero the rest;
    (N, K, H, W) -> the same shape."""
    pad = (kernel - 1) // 2
    N, K, H, W = heatmaps.shape
    x = F.pad(heatmaps.reshape(N * K, 1, H, W), (pad, pad, pad, pad), value=float("-inf"))
    pooled = F.max_pool2d(x, kernel, stride=1).reshape(N, K, H, W)
    return torch.where(pooled == heatmaps, heatmaps, torch.zeros_like(heatmaps))


def top_k_candidates(heatmaps: torch.Tensor, tags: torch.Tensor, k: int = 30
                     ) -> Dict[str, np.ndarray]:
    """Each joint's ``k`` strongest peaks of one image: heatmaps (K, H, W)
    after peak NMS, tags (K, H, W) or (K, H, W, T) -> numpy loc (K, k, 2)
    xy, val (K, k), tag (K, k, T).  Ties go to the lower flat index, as
    ``lax.top_k`` breaks them (``torch.topk`` alone does not promise an
    order among equal values, so the values are ranked by a stable sort)."""
    K, H, W = heatmaps.shape[:3]
    flat = heatmaps.reshape(K, H * W)
    idx = torch.sort(flat, dim=1, descending=True, stable=True).indices[:, :k]
    val = torch.gather(flat, 1, idx)
    if tags.dim() == 3:
        tags = tags[..., None]
    tag_k = torch.gather(tags.reshape(K, H * W, -1), 1,
                         idx[..., None].expand(-1, -1, tags.shape[-1]))
    loc = torch.stack([(idx % W).float(), (idx // W).float()], -1)
    return {"loc": loc.cpu().numpy(), "val": val.cpu().numpy(), "tag": tag_k.cpu().numpy()}


def match_by_tag(cands: Dict[str, np.ndarray], joint_order: List[int],
                 detection_threshold: float = 0.1, tag_threshold: float = 1.0,
                 max_people: int = 30, ignore_too_much: bool = False,
                 use_detection_val: bool = True) -> np.ndarray:
    """Assemble per-joint candidates into people by tag distance (reference
    group.py:28-118).  -> (P, K, 3 + T) float32: per person and joint x, y,
    score and the tag."""
    from scipy.optimize import linear_sum_assignment

    K = cands["val"].shape[0]
    T = cands["tag"].shape[-1]
    groups: List[np.ndarray] = []
    group_tags: List[List[np.ndarray]] = []
    for j in joint_order:
        vals = cands["val"][j]
        sel = vals > detection_threshold
        if not sel.any():
            continue
        locs, vals_j, tags_j = cands["loc"][j][sel], vals[sel], cands["tag"][j][sel]
        rows = np.concatenate([locs, vals_j[:, None], tags_j], axis=1)
        if not groups:
            for r in rows:
                groups.append(_new_group(K, T, j, r))
                group_tags.append([r[3:]])
            continue
        if ignore_too_much and len(groups) >= max_people:
            continue
        means = np.stack([np.mean(np.stack(t), axis=0) for t in group_tags])
        diff = np.linalg.norm(tags_j[:, None, :] - means[None], axis=2)
        cost = np.round(diff) * 100 - vals_j[:, None] if use_detection_val else diff.copy()
        n_c, n_g = cost.shape
        if n_c > n_g:                   # pad to square: every candidate may open a group
            cost = np.concatenate([cost, np.full((n_c, n_c - n_g), 1e10)], axis=1)
        for r, c in zip(*linear_sum_assignment(cost)):
            if c < n_g and diff[r, c] < tag_threshold:
                groups[c][j] = rows[r][:3 + T]
                group_tags[c].append(rows[r][3:])
            else:
                groups.append(_new_group(K, T, j, rows[r]))
                group_tags.append([rows[r][3:]])
    if not groups:
        return np.zeros((0, K, 3 + T), np.float32)
    return np.stack(groups)[:max_people].astype(np.float32)


def _new_group(K: int, T: int, j: int, row: np.ndarray) -> np.ndarray:
    g = np.zeros((K, 3 + T), np.float64)
    g[j] = row[:3 + T]
    return g


def parse_bottom_up(heatmaps, tags, joint_order: Optional[List[int]] = None,
                    detection_threshold: float = 0.1, tag_threshold: float = 1.0,
                    max_people: int = 30, top_k: int = 30) -> np.ndarray:
    """The whole bottom-up parse of one image: peak NMS, top-k, grouping."""
    heatmaps, tags = torch.as_tensor(heatmaps), torch.as_tensor(tags)
    K = heatmaps.shape[0]
    if joint_order is None:
        joint_order = list(range(K))
    nms = heatmap_peak_nms(heatmaps[None])[0]
    cands = top_k_candidates(nms, tags, k=top_k)
    return match_by_tag(cands, joint_order, detection_threshold, tag_threshold, max_people)
