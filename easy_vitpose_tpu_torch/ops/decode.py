"""Heatmap -> keypoint decoding (UDP), in PyTorch.

Port of the UDP path of ``easy_vitpose_tpu/ops/decode.py``:

* :func:`get_max_preds` — argmax decode, -1 where the max is <= 0;
* :func:`gaussian_blur_2d` — cv2.GaussianBlur(sigma=0) with reflect-101
  borders, as two separable passes;
* :func:`post_dark_udp` — the DARK/UDP Newton step on the log-modulated map,
  whose blur + clip + log is the modulate kernel's plain version
  (``ops/modulate.py``), as the reference's default ``use_pallas=False``;
* :func:`transform_preds` and :func:`keypoints_from_heatmaps_udp`;
* :func:`decode_keypoints` — the pose step's whole decode (the above, the
  un-crop to the frame and the slot mask) as one launch of
  ``csrc/decode.cu``; :func:`decode_keypoints_plain` is its plain version.

Batched over (N, K) with no host loop, and with no host synchronisation on
the card: the constants it needs on the device are made once per device.
"""
from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def gaussian_taps(kernel: int) -> Tuple[float, ...]:
    """:func:`gaussian_kernel_1d` as Python floats (exact float32 values),
    made once per kernel size."""
    return tuple(gaussian_kernel_1d(kernel).tolist())


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
    g = gaussian_taps(kernel)
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
    from .modulate import udp_modulate_plain

    N, K, H, W = heatmaps.shape
    hm = udp_modulate_plain(heatmaps, kernel)
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
    denom = _denominator(tuple(output_size), use_udp, coords.device)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which is not the IEEE division of the JAX version
    sxy = scale / denom
    return coords * sxy[:, None, :] + (center - scale * 0.5)[:, None, :]


@functools.lru_cache(maxsize=None)
def _denominator(output_size: Tuple[int, int], use_udp: bool,
                 device: torch.device) -> torch.Tensor:
    """(2,) float32 size, minus one with UDP, made once per device."""
    out = torch.tensor(output_size, dtype=torch.float32)
    return (out - 1.0 if use_udp else out).to(device)


def keypoints_from_heatmaps_udp(heatmaps: torch.Tensor, center: torch.Tensor,
                                scale: torch.Tensor, kernel: int = 11
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UDP decode: (preds (N, K, 2) image-space xy, maxvals (N, K, 1))."""
    N, K, H, W = heatmaps.shape
    preds, maxvals = get_max_preds(heatmaps)
    preds = post_dark_udp(preds, heatmaps, kernel=kernel)
    return transform_preds(preds, center, scale, (W, H), use_udp=True), maxvals


def newton_point_index(coords: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Where :func:`post_dark_udp` reads the modulated maps, as (N, K, 7)
    flat indices into the unpadded (N*K*H*W) maps, in the order i0, ix1,
    iy1, ix1y1, ix1_y1_, ix1_, iy1_: the decode kernel's index arithmetic.
    The flat take of the edge-padded batch, wrapped modulo its size, is a
    clamp of the padded row and column onto the map the index falls in."""
    N, K = coords.shape[:2]
    Wp = W + 2
    per_map, total = (H + 2) * Wp, N * K * (H + 2) * Wp
    maps = torch.arange(N * K, dtype=torch.int64, device=coords.device).reshape(N, K)
    base = (coords[..., 0].to(torch.int64) + 1 + (coords[..., 1].to(torch.int64) + 1) * Wp
            + per_map * maps)
    offsets = torch.tensor([0, 1, Wp, Wp + 1, -(Wp + 1), -1, -Wp], device=coords.device)
    f = (base[..., None] + offsets) % total
    m, rem = f // per_map, f % per_map
    y = torch.clamp(rem // Wp - 1, 0, H - 1)
    x = torch.clamp(rem % Wp - 1, 0, W - 1)
    return (m * H + y) * W + x


def decode_keypoints_plain(heat: torch.Tensor, geo: torch.Tensor, mask: torch.Tensor,
                           kernel: int = 11) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_keypoints`: the UDP decode
    with the padded crop's center (wp//2, hp//2) and size (wp, hp), the
    un-crop (x += x1 - left, y += y1 - top) and the mask, in eager ops."""
    from .preprocess import geometry_views

    g = geometry_views(geo)
    center = torch.stack([g["wp"] // 2, g["hp"] // 2], dim=-1).float()
    scale = torch.stack([g["wp"], g["hp"]], dim=-1).float()
    preds, maxvals = keypoints_from_heatmaps_udp(heat.float(), center, scale, kernel)
    off_x = (g["x1"] - g["left"]).float()[:, None]
    off_y = (g["y1"] - g["top"]).float()[:, None]
    kpts = torch.stack([preds[..., 1] + off_y, preds[..., 0] + off_x, maxvals[..., 0]], dim=-1)
    return torch.where(mask[:, None, None], kpts, torch.zeros_like(kpts))


def decode_keypoints(heat: torch.Tensor, geo: torch.Tensor, mask: torch.Tensor,
                     kernel: int = 11, with_points: bool = False):
    """The pose step's decode: (M, K, H, W) heatmaps (float32, or bfloat16
    widened as ``.float()`` widens it), the packed (M, 8) int32 crop
    geometry (:func:`..ops.sampler.crop_normalize`) and the (M,) bool slot
    mask -> (M, K, 3) float32 keypoints (y, x, score) in frame coordinates;
    masked slots are zero.

    Heatmaps on the CPU take the plain version; CUDA heatmaps launch
    ``csrc/decode.cu`` once.  Its arithmetic is the plain version's, op for
    op: argmax and score are the same bits, and the seven modulated points
    are :func:`..ops.modulate.modulate_at_plain`'s.

    ``with_points=True`` also returns the (M, K, 7) modulated values the
    Newton step read (at :func:`newton_point_index`; zero in masked slots),
    to hold them against the full-map kernel.
    """
    from .modulate import check_kernel_size, modulate_at_plain, taps_struct

    if heat.device.type == "cpu":
        kpts = decode_keypoints_plain(heat, geo, mask, kernel)
        if not with_points:
            return kpts
        coords, _ = get_max_preds(heat.float())
        pts = modulate_at_plain(heat, newton_point_index(coords, *heat.shape[-2:]), kernel)
        return kpts, torch.where(mask[:, None, None], pts, torch.zeros_like(pts))
    from .. import kernels

    dev = kernels.require_cuda(heat, geo, mask)
    if heat.dim() != 4 or heat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"heatmaps must be (M, K, H, W) float32 or bfloat16, got "
                         f"{tuple(heat.shape)} {heat.dtype}")
    M, K, H, W = heat.shape
    if tuple(geo.shape) != (M, 8) or geo.dtype != torch.int32:
        raise ValueError(f"geometry must be ({M}, 8) int32, got {tuple(geo.shape)} {geo.dtype}")
    if tuple(mask.shape) != (M,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({M},) bool, got {tuple(mask.shape)} {mask.dtype}")
    check_kernel_size(kernel, H, W)
    heat, geo, mask = heat.contiguous(), geo.contiguous(), mask.contiguous()
    out = torch.empty((M, K, 3), dtype=torch.float32, device=dev)
    pts = torch.zeros((M, K, 7), dtype=torch.float32, device=dev) if with_points else None
    if out.numel():
        kernels.call("decode", "evt_decode_keypoints", dev, heat.data_ptr(),
                     int(heat.dtype == torch.bfloat16), geo.data_ptr(), mask.data_ptr(),
                     taps_struct(kernel), out.data_ptr(), pts.data_ptr() if with_points else None,
                     M, K, H, W, kernel // 2)
        kernels.count_launch("decode")
    return (out, pts) if with_points else out
