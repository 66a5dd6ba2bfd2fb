"""Crop geometry, the plain crop sampler and the ImageNet normalize.

Port of ``easy_vitpose_tpu/ops/preprocess.py``.  Each box becomes the
reference's crop: banker's rounding of the float box (``np.round``), the
+/-10 px inflation clipped to the frame, the zero pad to a 3:4 aspect (pad
split ``pad // 2``), and a bilinear resize to 192x256 with cv2's half-pixel
map clamped at the padded crop's edges.

The sampler here is the direct 4-tap gather, the contract of the crop
kernel (``ops/sampler.py``): each output pixel reads the two x taps and two
y taps of the padded crop, taps outside the crop are zero, and frame indices
are clamped to the frame.  The TPU's matmul formulations are not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs import IMAGE_SIZE, IMAGENET_MEAN, IMAGENET_STD

PAD_BBOX = 10              # reference easy_ViTPose/inference.py:254
ASPECT_W, ASPECT_H = 3, 4  # crop aspect ratio 3/4
GEO_KEYS = ("x1", "y1", "wc", "hc", "wp", "hp", "left", "top")

Geometry = Dict[str, torch.Tensor]


def crop_geometry(boxes: torch.Tensor, frame_hw: Tuple[int, int]) -> Geometry:
    """Integer crop/pad geometry per box.

    Args:
      boxes: (M, 4) float [x1, y1, x2, y2] detector boxes (before inflation).
      frame_hw: (H, W) of the frame.
    Returns:
      dict of (M,) int32 tensors: x1, y1 (inflated, clipped crop origin),
      wc, hc (crop size), wp, hp (padded size), left, top (pad offsets).
    """
    H, W = frame_hw
    b = torch.round(boxes.float()).to(torch.int32)   # half to even, as np.round
    x1 = torch.clamp(b[:, 0] - PAD_BBOX, 0, W)
    y1 = torch.clamp(b[:, 1] - PAD_BBOX, 0, H)
    x2 = torch.clamp(b[:, 2] + PAD_BBOX, 0, W)
    y2 = torch.clamp(b[:, 3] + PAD_BBOX, 0, H)
    wc = torch.clamp(x2 - x1, min=1)
    hc = torch.clamp(y2 - y1, min=1)
    pad_horiz = ASPECT_H * wc < ASPECT_W * hc
    wp = torch.where(pad_horiz, (ASPECT_W * hc) // ASPECT_H, wc)
    hp = torch.where(pad_horiz, hc, (ASPECT_H * wc) // ASPECT_W)
    # int(w / 0.75) can round below w; the reference keeps the crop size then
    wp = torch.maximum(wp, wc)
    hp = torch.maximum(hp, hc)
    zero = torch.zeros_like(wc)
    left = torch.where(pad_horiz, (wp - wc) // 2, zero)
    top = torch.where(pad_horiz, zero, (hp - hc) // 2)
    return {"x1": x1, "y1": y1, "wc": wc, "hc": hc,
            "wp": wp, "hp": hp, "left": left, "top": top}


def _taps(size_p: torch.Tensor, lo: torch.Tensor, size: torch.Tensor,
          origin: torch.Tensor, n_out: int, n_frame: int):
    """Both bilinear taps of one axis for every crop: frame index (clamped),
    in-crop mask and weight of tap 0 and tap 1, each (M, n_out)."""
    sp = size_p.float()[:, None]
    o = torch.arange(n_out, dtype=torch.float32, device=size_p.device)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which is not the kernel's IEEE division
    s = (o + 0.5)[None, :] * (sp / torch.full_like(sp, n_out)) - 0.5
    s = torch.minimum(torch.clamp(s, min=0.0), sp - 1.0)
    i0 = torch.floor(s).to(torch.int32)
    f = s - i0
    i1 = torch.minimum(i0 + 1, size_p[:, None] - 1)
    lo_, hi_, org = lo[:, None], (lo + size)[:, None], origin[:, None]

    def tap(i):
        inside = (i >= lo_) & (i < hi_)
        return torch.clamp(i - lo_ + org, 0, n_frame - 1).long(), inside

    (g0, in0), (g1, in1) = tap(i0), tap(i1)
    return g0, in0, 1.0 - f, g1, in1, f


def sample_crops(frame: torch.Tensor, geo: Geometry,
                 out_wh: Tuple[int, int] = IMAGE_SIZE) -> torch.Tensor:
    """Bilinear crop + zero pad + resize of every box, in float32.

    Args:
      frame: (H, W, 3) uint8 RGB frame.
      geo: :func:`crop_geometry` of M boxes.
    Returns:
      (M, OH, OW, 3) float32 crops in [0, 255].
    """
    H, W = frame.shape[:2]
    OW, OH = out_wh
    f = frame.float()
    gx0, inx0, wx0, gx1, inx1, wx1 = _taps(geo["wp"], geo["left"], geo["wc"],
                                           geo["x1"], OW, W)
    gy0, iny0, wy0, gy1, iny1, wy1 = _taps(geo["hp"], geo["top"], geo["hc"],
                                           geo["y1"], OH, H)

    def x_lerp(gy):       # (M, OH) frame rows -> (M, OH, OW, 3)
        rows = gy[:, :, None]
        c0 = f[rows, gx0[:, None, :]] * inx0[:, None, :, None]
        c1 = f[rows, gx1[:, None, :]] * inx1[:, None, :, None]
        return c0 * wx0[:, None, :, None] + c1 * wx1[:, None, :, None]

    r0 = x_lerp(gy0) * iny0[:, :, None, None]
    r1 = x_lerp(gy1) * iny1[:, :, None, None]
    return r0 * wy0[:, :, None, None] + r1 * wy1[:, :, None, None]


def imagenet_mean_std(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet mean and std on the [0, 255] scale, float32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device) * 255.0
    return mean, std


def normalize_crops(crops: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """ImageNet normalize of [0, 255] crops, cast to ``dtype``."""
    mean, std = imagenet_mean_std(crops.device)
    return ((crops.float() - mean) / std).to(dtype)


def pack_geometry(geo: Geometry) -> torch.Tensor:
    """(M, 8) int32 rows [x1, y1, wc, hc, wp, hp, left, top] for the kernel."""
    return torch.stack([geo[k] for k in GEO_KEYS], dim=-1).to(torch.int32).contiguous()
