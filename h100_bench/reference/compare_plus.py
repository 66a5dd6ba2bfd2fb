"""The numbers that decide a mixed-task pose cell's ``correct``.

A step's (M, K_max, 3) keypoints against the reference's heatmaps and decode
of the same frame, boxes and tasks (``vitpose_plus_ref.pose``), read as
``compare.pose_numbers`` reads a single-task step, over every box at once:

* ``score_gap``: the largest gap between a keypoint's score and the
  reference's, over the range of the reference's map of that keypoint;
* ``moved_median``: the median distance, in heatmap pixels, between a
  keypoint and the reference's, over the keypoints of every live box (each
  box its own K), so that a task with few boxes weighs by its keypoints;
* ``masked_nonzero``: values of masked boxes that are not exactly 0;
* ``not_finite``: values that are not finite;
* ``beyond_k_nonzero``: values in a box's rows past its task's K that are
  not exactly 0.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from reference.compare import MOVE_PX


def plus_numbers(kp: torch.Tensor, mask: torch.Tensor, tasks: Sequence[int],
                 heats: Dict[int, torch.Tensor], ref: torch.Tensor,
                 geo) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(compared numbers, diagnostics) of one step's keypoints."""
    kp = kp.to(ref.device, torch.float32)
    mask = mask.to(ref.device)
    t = torch.as_tensor(list(tasks), dtype=torch.int64, device=ref.device)
    not_finite = float((~torch.isfinite(kp)).sum())
    masked_nonzero = float((kp[~mask] != 0).sum())
    beyond, scores, moves = 0.0, [], []
    for e, heat in heats.items():
        idx = (t == e).nonzero()[:, 0]
        K = heat.shape[1]
        beyond += float((kp[idx, K:] != 0).sum())
        live = mask[idx]
        a, b = kp[idx, :K][live], ref[idx, :K][live]
        h = heat[live]
        span = (h.amax((2, 3)) - h.amin((2, 3))).clamp_min(1e-30)
        scores.append(((a[..., 2] - b[..., 2]).abs() / span).reshape(-1))
        H, W = heat.shape[-2:]
        g = {k: v[idx][live] for k, v in geo.items()}
        dy = (a[..., 0] - b[..., 0]) * (H - 1) / g["hp"].float()[:, None]
        dx = (a[..., 1] - b[..., 1]) * (W - 1) / g["wp"].float()[:, None]
        d = torch.sqrt(dx * dx + dy * dy).reshape(-1)
        moves.append(torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf"))))
    score, d = torch.cat(scores), torch.cat(moves)
    nums = {"score_gap": float(score.nan_to_num(float("inf")).max()),
            "moved_median": float(d.median()),
            "masked_nonzero": masked_nonzero, "not_finite": not_finite,
            "beyond_k_nonzero": beyond}
    diag = {"moved_share": float((d > MOVE_PX).float().mean()),
            "moved_px_p90": float(d.quantile(0.9)), "score_gap_median": float(score.median())}
    return nums, diag
