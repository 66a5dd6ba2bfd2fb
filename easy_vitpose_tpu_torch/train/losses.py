"""Training loss (port of ``easy_vitpose_tpu/train/losses.py::joints_mse_loss``)."""
from __future__ import annotations

import torch


def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    target_weight: torch.Tensor) -> torch.Tensor:
    """JointsMSELoss: the mean over (B, K, H*W) of ``(pred*w - target*w)^2``
    in float32, for (B, K, H, W) maps and (B, K, 1) weights."""
    B, K = pred.shape[:2]
    w = target_weight.reshape(B, K, 1).float()
    p = pred.reshape(B, K, -1).float() * w
    t = target.reshape(B, K, -1).float() * w
    return torch.mean((p - t) ** 2)
