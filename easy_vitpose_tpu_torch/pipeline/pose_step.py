"""The per-frame pose step: boxes -> keypoints, on the card.

Port of ``easy_vitpose_tpu/pipeline/pose_step.py``.  For one uint8 frame and
a fixed batch of M person slots:

  frame (H, W, 3) uint8 + boxes (M, 4) + mask (M,)
    -> crop_geometry, then the crop kernel with the normalize fused (K3)
    -> ViTPose forward: blocks through K1 (fp32/bf16) or K2 (int8)
    -> UDP decode, whose blur + clip + log is K4
    -> un-crop to frame coordinates
    -> (M, K, 3) keypoints as (y, x, score); masked slots are all-zero.

The model's dtype is the serving choice (``models.vitpose.serving_copy``).
The step runs on CUDA unless the caller asks for the CPU: pass
``device="cpu"`` or CPU tensors, and the kernels' plain versions run.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import IMAGE_SIZE
from ..models.vitpose import ViTPose, compute_dtype, vitpose_forward
from ..ops.affine import flip_back_heatmaps
from ..ops.decode import keypoints_from_heatmaps_udp
from ..ops.preprocess import Geometry, crop_geometry
from ..ops.sampler import sample_normalize, sample_normalize_plain

ArrayLike = Union[np.ndarray, torch.Tensor]


def resolve_device(device, frame: ArrayLike) -> torch.device:
    """The device a step runs on: ``device`` if given, else the frame's if it
    is a tensor, else CUDA.  Raises when that is CUDA and there is none."""
    if device is None:
        device = frame.device if isinstance(frame, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the pose step runs on CUDA and no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _to(x: ArrayLike, device: torch.device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.to(device=device, dtype=dtype or t.dtype)


def pose_heatmaps(model: ViTPose, frame: torch.Tensor, boxes: torch.Tensor, *,
                  flip_pairs: Optional[Sequence[Sequence[int]]] = None,
                  plain: bool = False) -> Tuple[torch.Tensor, Geometry]:
    """Crop, sample and forward every box: ((M, K, 64, 48) float32 heatmaps,
    crop geometry).  Tensors must already be on the model's device.
    ``plain=True`` runs the kernels' plain versions on any device."""
    geo = crop_geometry(boxes, tuple(frame.shape[:2]))
    sample = sample_normalize_plain if plain else sample_normalize
    x = sample(frame, geo, IMAGE_SIZE, compute_dtype(model))
    heat = vitpose_forward(model, x, plain=plain).float()
    if flip_pairs is not None:
        # flip test: forward the mirrored crop, un-flip, average
        flipped = vitpose_forward(model, x.flip(2), plain=plain).float()
        heat = 0.5 * (heat + flip_back_heatmaps(flipped, flip_pairs))
    return heat, geo


@torch.no_grad()
def pose_step(model: ViTPose, frame: ArrayLike, boxes: ArrayLike, mask: ArrayLike, *,
              flip_pairs: Optional[Sequence[Sequence[int]]] = None,
              device=None) -> torch.Tensor:
    """Pose estimation for up to M people on one frame.

    Args:
      model: a serving copy of ViTPose on ``device``.
      frame: (H, W, 3) uint8 RGB frame (numpy or tensor).
      boxes: (M, 4) float32 [x1, y1, x2, y2] boxes.
      mask: (M,) bool; False slots are padding.
      device: where to run; default: the frame's device if it is a tensor,
        else CUDA (raises if there is none).
    Returns:
      (M, K, 3) float32 keypoints as (y, x, score) in frame coordinates;
      masked slots are all-zero.
    """
    device = resolve_device(device, frame)
    if model.backbone.pos_embed.device != device:
        raise ValueError(f"model is on {model.backbone.pos_embed.device}, step on {device}")
    frame = _to(frame, device)
    boxes = _to(boxes, device, torch.float32)
    mask = _to(mask, device, torch.bool)
    heat, geo = pose_heatmaps(model, frame, boxes, flip_pairs=flip_pairs)
    # decode with the padded crop's center (w//2, h//2) and size (w, h)
    center = torch.stack([geo["wp"] // 2, geo["hp"] // 2], dim=-1).float()
    scale = torch.stack([geo["wp"], geo["hp"]], dim=-1).float()
    preds, maxvals = keypoints_from_heatmaps_udp(heat, center, scale)
    off_x = (geo["x1"] - geo["left"]).float()[:, None]
    off_y = (geo["y1"] - geo["top"]).float()[:, None]
    kpts = torch.stack([preds[..., 1] + off_y, preds[..., 0] + off_x, maxvals[..., 0]], dim=-1)
    return torch.where(mask[:, None, None], kpts, torch.zeros_like(kpts))


def bucket_slots(n: int, min_slots: int = 1, max_slots: int = 64) -> int:
    """Person-slot count for n detections: the next power of two, capped."""
    m = min_slots
    while m < n:
        m *= 2
    return min(m, max_slots)
