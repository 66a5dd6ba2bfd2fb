"""The numbers that decide ``correct``, each held to its limit.

Pose keypoints (rows (y, x, score) in frame pixels) against the reference's
heatmaps and decode on the same frame and boxes:

* ``score_gap``: the largest gap between a keypoint's score and the
  reference's, over the range of the reference's map.  A score is a map's
  maximum, so two near-equal peaks that swap under rounding give near-equal
  scores: this reads rounding, not ties.
* ``moved_median``: the median distance, in heatmap pixels, between a
  keypoint and the reference's.  With random weights a map often holds
  near-equal peaks, or a flat top where the Newton step runs far, so a
  fifth to a quarter of keypoints move several pixels under rounding
  alone (the share moved more than ``MOVE_PX`` is printed beside it); the
  median reads the rest, and any error that moves most keypoints.
* ``masked_nonzero``: values of masked slots that are not exactly 0.
* ``not_finite``: values that are not finite.

Training, from the state of the step it is handed, against the reference
following the same three steps from the same weights, batches and masks:

* ``loss1_gap``, ``loss_gap`` (printed, not compared): the relative gap
  of the first step's loss and the largest of the three.  The head's
  BatchNorm renormalises what the backbone's rounding does, so the loss
  barely tells the control (fp8) from sound runs;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer holds it (its first moment after one step,
  read back from its codes), over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``change_gap``: as ``grad_gap``, for the change of each parameter over
  the three steps.  Leaves whose first gradient in the reference is under a
  thousandth of the median leaf's are left out: Adam moves them by
  round-off alone.
* ``grad_diff``, ``change_diff``: as the two above with the norm of the
  difference in place of the gap of the norms.  A norm hides rounding
  that is spread over a leaf; the difference shows it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MOVE_PX = 0.5


def pose_numbers(kp: torch.Tensor, mask: torch.Tensor, heat: torch.Tensor,
                 ref: torch.Tensor, geo) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(compared numbers, diagnostics) of one step's (M, K, 3) keypoints."""
    kp = kp.to(ref.device, torch.float32)
    not_finite = float((~torch.isfinite(kp)).sum())
    masked_nonzero = float((kp[~mask] != 0).sum())
    valid = mask[:, None].expand(kp.shape[:2])
    span = (heat.amax((2, 3)) - heat.amin((2, 3))).clamp_min(1e-30)
    score = ((kp[..., 2] - ref[..., 2]).abs() / span)[valid]
    H, W = heat.shape[-2:]
    dy = (kp[..., 0] - ref[..., 0]) * (H - 1) / geo["hp"].float()[:, None]
    dx = (kp[..., 1] - ref[..., 1]) * (W - 1) / geo["wp"].float()[:, None]
    d = torch.sqrt(dx * dx + dy * dy)[valid]
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    nums = {"score_gap": float(score.nan_to_num(float("inf")).max()),
            "moved_median": float(d.median()),
            "masked_nonzero": masked_nonzero, "not_finite": not_finite}
    diag = {"moved_share": float((d > MOVE_PX).float().mean()),
            "moved_px_p90": float(d.quantile(0.9)), "score_gap_median": float(score.median())}
    return nums, diag


def worst(parts: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several comparisons; a
    share is averaged."""
    out = {}
    for k in dict.fromkeys(k for p in parts for k in p):
        vals = [p[k] for p in parts if k in p]
        out[k] = sum(vals) / len(vals) if k.endswith("_share") else max(vals)
    return out


def leaf_readings(prog, ref, names) -> Tuple[float, float]:
    """Over the leaves ``names`` of two trees of tensors: the worst leaf's
    gap of norms, |‖prog‖ - ‖ref‖|, and of the norm of the difference,
    ‖prog - ref‖, each over the larger of the reference's norm of that leaf
    and of the median leaf."""
    norms = {k: float(ref(k).norm()) for k in names}
    med = float(torch.tensor(list(norms.values())).median())
    gap = diff = 0.0
    for k in names:
        a, b = prog(k), ref(k)
        base = max(norms[k], med, 1e-30)
        gap = max(gap, abs(float(a.norm()) - norms[k]) / base)
        diff = max(diff, float((a - b).norm()) / base)
    return gap, diff


def train_numbers(prog: Dict[str, object], ref: Dict[str, object], p0):
    """(compared numbers, the loss gaps) of a training run.  ``prog`` and
    ``ref`` hold ``losses`` (three floats), ``mu1`` (the first moment after
    one step, read back, by leaf) and ``p3`` (the parameters after the
    three); ``ref`` also ``grad_raw``, the norms of its first gradients."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if any(x != x for x in prog["losses"]):
        gaps = [float("inf")] * len(gaps)
    raw = ref["grad_raw"]
    med = float(torch.tensor(list(raw.values())).median())
    moved = [k for k in raw if raw[k] >= 1e-3 * med]
    grad_gap, grad_diff = leaf_readings(prog["mu1"], ref["mu1"], list(raw))
    change_gap, change_diff = leaf_readings(lambda k: prog["p3"](k) - p0[k],
                                            lambda k: ref["p3"](k) - p0[k], moved)
    return ({"grad_gap": grad_gap, "grad_diff": grad_diff, "change_gap": change_gap,
             "change_diff": change_diff},
            {"loss1_gap": gaps[0], "loss_gap": max(gaps)})


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit (None where none is set yet)."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}


def passes(compared: Dict[str, Dict[str, float]]) -> bool:
    """Every number at or under its limit; a number with no limit fails."""
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values())
