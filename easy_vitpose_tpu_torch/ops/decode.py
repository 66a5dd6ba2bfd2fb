"""Heatmap -> keypoint decoding (UDP), in PyTorch.

Port of the UDP path of ``easy_vitpose_tpu/ops/decode.py``:

* :func:`get_max_preds` — argmax decode, -1 where the max is <= 0;
* :func:`gaussian_blur_2d` — cv2.GaussianBlur(sigma=0) with reflect-101
  borders, as two separable passes;
* :func:`post_dark_udp` — the DARK/UDP Newton step on the log-modulated map,
  whose blur + clip + log is the modulate kernel (``ops/modulate.py``);
* :func:`transform_preds` and :func:`keypoints_from_heatmaps_udp`.

Batched over (N, K) with no host loop.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(kernel: int) -> np.ndarray:
    """cv2.getGaussianKernel(kernel, sigma=0) for kernel > 7: the sampled,
    normalized Gaussian with sigma = 0.3*((k-1)*0.5-1)+0.8."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel, dtype=np.float64) - (kernel - 1) * 0.5
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def get_max_preds(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K, H, W) -> preds (N, K, 2) xy of the first maximum, maxvals
    (N, K, 1); preds are -1 where the maximum is <= 0."""
    N, K, H, W = heatmaps.shape
    flat = heatmaps.reshape(N, K, H * W)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)[..., None]
    preds = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    preds = torch.where(maxvals > 0.0, preds, torch.full_like(preds, -1.0))
    return preds, maxvals


def gaussian_blur_2d(heatmaps: torch.Tensor, kernel: int) -> torch.Tensor:
    """Separable Gaussian blur of the last two dims of (N, K, H, W) with
    reflect-101 borders, summing the taps in order as the JAX version does."""
    r = kernel // 2
    g = gaussian_kernel_1d(kernel).tolist()
    H, W = heatmaps.shape[-2:]
    x = F.pad(heatmaps.float(), (r, r, r, r), mode="reflect")
    h = sum(x[..., :, i:i + W] * g[i] for i in range(kernel))
    return sum(h[..., i:i + H, :] * g[i] for i in range(kernel))


def post_dark_udp(coords: torch.Tensor, heatmaps: torch.Tensor,
                  kernel: int = 11) -> torch.Tensor:
    """DARK/UDP sub-pixel refinement of (N, K, 2) integer argmax coords.

    The modulated map is edge-padded by one and flattened over the WHOLE
    batch, and the finite differences read it with wrap-around, as the
    reference does: a border or -1 coordinate reads the neighbouring map.
    """
    from .modulate import udp_modulate

    N, K, H, W = heatmaps.shape
    hm = udp_modulate(heatmaps, kernel)
    hm = F.pad(hm, (1, 1, 1, 1), mode="replicate")
    flat = hm.reshape(-1)
    ix = coords[..., 0].to(torch.int64) + 1
    iy = coords[..., 1].to(torch.int64) + 1
    per_map = (H + 2) * (W + 2)
    maps = torch.arange(N * K, dtype=torch.int64, device=coords.device).reshape(N, K)
    base = ix + iy * (W + 2) + per_map * maps

    def take(offset):
        return flat[(base + offset) % flat.numel()]

    i0 = take(0)
    ix1, iy1, ix1y1 = take(1), take(W + 2), take(W + 3)
    ix1_y1_, ix1_, iy1_ = take(-(W + 3)), take(-1), take(-(W + 2))

    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2.0 * i0 + ix1_
    dyy = iy1 - 2.0 * i0 + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2.0 * i0 - ix1_ - iy1_ + ix1_y1_)

    eps = float(np.finfo(np.float32).eps)
    a = dxx + eps
    d = dyy + eps
    inv_det = 1.0 / (a * d - dxy * dxy)
    off_x = (d * dx - dxy * dy) * inv_det
    off_y = (a * dy - dxy * dx) * inv_det
    return coords - torch.stack([off_x, off_y], dim=-1)


def transform_preds(coords: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                    output_size: Tuple[int, int], use_udp: bool = True) -> torch.Tensor:
    """Heatmap-space (N, K, 2) xy -> image space, for box ``center`` (N, 2)
    and pixel size ``scale`` (N, 2); UDP divides by size - 1."""
    out = torch.tensor(output_size, dtype=torch.float32, device=coords.device)
    denom = out - 1.0 if use_udp else out
    sxy = scale / denom
    return coords * sxy[:, None, :] + (center - scale * 0.5)[:, None, :]


def keypoints_from_heatmaps_udp(heatmaps: torch.Tensor, center: torch.Tensor,
                                scale: torch.Tensor, kernel: int = 11
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UDP decode: (preds (N, K, 2) image-space xy, maxvals (N, K, 1))."""
    N, K, H, W = heatmaps.shape
    preds, maxvals = get_max_preds(heatmaps)
    preds = post_dark_udp(preds, heatmaps, kernel=kernel)
    return transform_preds(preds, center, scale, (W, H), use_udp=True), maxvals
