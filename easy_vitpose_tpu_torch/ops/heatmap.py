"""Gaussian heatmap targets for training, rendered on the device.

Port of ``easy_vitpose_tpu/ops/heatmap.py::generate_gaussian_targets_jnp``,
the batched renderer of the device-input training path, with the
reference's quirks (``datasets/COCO.py:384-439``):

* joint -> heatmap cell: ``int(x / stride + 0.5)`` with truncation, not
  floor, so negative coordinates round toward zero;
* a joint whose +/-3-sigma box lies wholly outside the map gets weight 0;
* the Gaussian is unnormalized (peak 1) on the integer grid around the
  truncated centre, cropped to the map.

Divisions are by tensors: CUDA divides by a Python scalar as a multiply by
its reciprocal, which is not JAX's division.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs import HEATMAP_SIZE, IMAGE_SIZE

SIGMA = 3.0     # of the target Gaussian, in heatmap cells (the JAX renderer's default)


def generate_gaussian_targets(joints: torch.Tensor, joints_vis: torch.Tensor,
                              heatmap_size: Tuple[int, int] = HEATMAP_SIZE,
                              image_size: Tuple[int, int] = IMAGE_SIZE,
                              sigma: float = SIGMA,
                              joints_weight: Optional[torch.Tensor] = None,
                              use_different_joints_weight: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 2) joint xy in input pixels and (B, K, 2) visibility (first
    column used) -> (B, K, Hh, Wh) float32 targets and (B, K, 1) weights.
    ``heatmap_size`` and ``image_size`` are (W, H); the weights are scaled by
    the (K, 1) ``joints_weight`` only with ``use_different_joints_weight``,
    as JAX's renderer does."""
    dev = joints.device
    Wh, Hh = heatmap_size
    Wi, Hi = image_size
    tmp_size = sigma * 3

    stride = torch.tensor([Wi / Wh, Hi / Hh], dtype=torch.float32, device=dev)
    mu = torch.trunc(joints[..., :2].float() / stride + 0.5)
    ul = torch.trunc(mu - tmp_size).to(torch.int32)
    br = torch.trunc(mu + tmp_size + 1).to(torch.int32)

    weight = joints_vis[..., 0].float()
    oob = (ul[..., 0] >= Wh) | (ul[..., 1] >= Hh) | (br[..., 0] < 0) | (br[..., 1] < 0)
    weight = torch.where(oob, torch.zeros_like(weight), weight)

    x0 = int(2 * tmp_size + 1) // 2
    xs = torch.arange(Wh, dtype=torch.int32, device=dev)[None, None, None, :]
    ys = torch.arange(Hh, dtype=torch.int32, device=dev)[None, None, :, None]
    ulx, uly = ul[..., 0][..., None, None], ul[..., 1][..., None, None]
    gx = (xs - ulx - x0).float()
    gy = (ys - uly - x0).float()
    d2 = -(gx ** 2 + gy ** 2)
    g = torch.exp(d2 / torch.full_like(d2[:1, :1, :1, :1], 2.0 * sigma ** 2))
    inside = ((xs >= ulx) & (xs < br[..., 0][..., None, None])
              & (ys >= uly) & (ys < br[..., 1][..., None, None]))
    target = torch.where(inside & (weight[..., None, None] > 0.5), g, torch.zeros_like(g))
    weight = weight[..., None]
    if use_different_joints_weight and joints_weight is not None:
        weight = weight * torch.as_tensor(joints_weight, dtype=torch.float32, device=dev)
    return target, weight
