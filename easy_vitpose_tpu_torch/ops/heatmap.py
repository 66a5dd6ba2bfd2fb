"""Gaussian heatmap targets for training.

Port of ``easy_vitpose_tpu/ops/heatmap.py``: :func:`generate_gaussian_targets_np`
is the host renderer of one instance (the dataset's, numpy, rendered in
float64 and cast, bit for bit the JAX package's
``generate_gaussian_targets``); :func:`generate_gaussian_targets` is the
batched device renderer of the device-input training path
(``generate_gaussian_targets_jnp``).  Both keep the reference's quirks
(``datasets/COCO.py:384-439``):

* joint -> heatmap cell: ``int(x / stride + 0.5)`` with truncation, not
  floor, so negative coordinates round toward zero;
* a joint whose +/-3-sigma box lies wholly outside the map gets weight 0;
* the Gaussian is unnormalized (peak 1) on the integer grid around the
  truncated centre, cropped to the map.

Divisions are by tensors: CUDA divides by a Python scalar as a multiply by
its reciprocal, which is not JAX's division.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..configs import HEATMAP_SIZE, IMAGE_SIZE

SIGMA = 3.0     # of the target Gaussian, in heatmap cells (the JAX renderer's default)


def generate_gaussian_targets_np(joints: np.ndarray, joints_vis: np.ndarray,
                                 heatmap_size: Tuple[int, int] = HEATMAP_SIZE,
                                 image_size: Tuple[int, int] = IMAGE_SIZE,
                                 sigma: float = SIGMA,
                                 joints_weight: np.ndarray = None,
                                 use_different_joints_weight: bool = False
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Render (K, Hh, Wh) Gaussian targets + (K, 1) weights for ONE instance.

    Args:
      joints: (K, 2) xy in input-image pixels.
      joints_vis: (K, 1+) visibility (first column used).
      heatmap_size: (Wh, Hh); image_size: (Wi, Hi).
    """
    Wh, Hh = heatmap_size
    Wi, Hi = image_size
    tmp_size = sigma * 3

    stride = np.array([Wi / Wh, Hi / Hh], np.float32)
    mu = np.trunc(joints[:, :2] / stride + 0.5).astype(np.int64)  # int() trunc
    ul = np.trunc(mu - tmp_size).astype(np.int64)                 # (K, 2)
    br = np.trunc(mu + tmp_size + 1).astype(np.int64)

    weight = joints_vis[:, 0].astype(np.float32).copy()
    oob = ((ul[:, 0] >= Wh) | (ul[:, 1] >= Hh)
           | (br[:, 0] < 0) | (br[:, 1] < 0))
    weight = np.where(oob, 0.0, weight)

    # vectorized paste: value at map cell (y, x) for joint k is
    # g((x - ul_x_k) - size//2, (y - ul_y_k) - size//2) when inside the
    # k-th gaussian window, else 0.
    size = int(2 * tmp_size + 1)
    x0 = size // 2
    xs = np.arange(Wh)[None, None, :]     # (1, 1, Wh)
    ys = np.arange(Hh)[None, :, None]     # (1, Hh, 1)
    gx = xs - ul[:, 0][:, None, None] - x0
    gy = ys - ul[:, 1][:, None, None] - x0
    g = np.exp(-(gx ** 2 + gy ** 2) / (2.0 * sigma ** 2))
    inside = ((xs >= ul[:, 0][:, None, None]) & (xs < br[:, 0][:, None, None])
              & (ys >= ul[:, 1][:, None, None]) & (ys < br[:, 1][:, None, None]))
    target = np.where(inside & (weight[:, None, None] > 0.5), g, 0.0)

    weight = weight[:, None]
    if use_different_joints_weight and joints_weight is not None:
        weight = weight * joints_weight
    return target.astype(np.float32), weight.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _stride(heatmap_size: Tuple[int, int], image_size: Tuple[int, int],
            device: torch.device) -> torch.Tensor:
    """(2,) float32 input pixels per heatmap cell, made once per device (a
    CUDA tensor built from Python numbers makes the host wait for the
    card).  Callers must not write to it."""
    (Wh, Hh), (Wi, Hi) = heatmap_size, image_size
    return torch.tensor([Wi / Wh, Hi / Hh], dtype=torch.float32).to(device)


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
    tmp_size = sigma * 3

    stride = _stride(tuple(heatmap_size), tuple(image_size), dev)
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
