"""Flip-test helper, in PyTorch (port of ``ops/affine.py::flip_back_heatmaps``
for Gaussian heatmaps)."""
from __future__ import annotations

from typing import Sequence

import torch


def flip_back_heatmaps(heatmaps: torch.Tensor,
                       flip_pairs: Sequence[Sequence[int]]) -> torch.Tensor:
    """Un-flip (N, K, H, W) heatmaps of a horizontally flipped input: swap
    the left/right channels, then mirror the width."""
    perm = list(range(heatmaps.shape[1]))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return heatmaps[:, perm].flip(-1)
