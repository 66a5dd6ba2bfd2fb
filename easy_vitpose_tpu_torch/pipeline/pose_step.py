"""The per-frame pose step: boxes -> keypoints, on the card.

Port of ``easy_vitpose_tpu/pipeline/pose_step.py``.  For one uint8 frame and
a fixed batch of M person slots:

  frame (H, W, 3) uint8 + boxes (M, 4) + mask (M,)
    -> crop geometry, crop, pad, resize and normalize: one launch (K3)
    -> ViTPose forward: blocks through K1 (fp32/bf16) or K2 (int8)
    -> UDP decode, un-crop to frame coordinates and the mask: one launch
    -> (M, K, 3) keypoints as (y, x, score); masked slots are all-zero.

On the card the step makes the host wait for nothing: with its inputs
already there, the host can queue the next step while the card runs this
one.  The model's dtype is the serving choice (``models.vitpose.serving_copy``).
The step runs on CUDA unless the caller asks for the CPU: pass
``device="cpu"`` or CPU tensors, and the kernels' plain versions run.

Given a stack of frames (S, H, W, 3) and ``frame_idx``, one step poses boxes
from many frames (multi-stream ticks, batched windows): each crop reads its
own frame, boxes stay frame-local (JAX's ``pose_step(frame_idx=)``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import IMAGE_SIZE
from ..kernels import resolve_device
from ..models.vitpose import ViTPose, compute_dtype, vitpose_forward
from ..ops.affine import flip_back_heatmaps
from ..ops.decode import decode_keypoints, decode_keypoints_plain
from ..ops.preprocess import Geometry, geometry_views
from ..ops.sampler import crop_normalize, crop_normalize_plain
from ..utils.profiling import span

ArrayLike = Union[np.ndarray, torch.Tensor]


def _to(x: ArrayLike, device: torch.device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.to(device=device, dtype=dtype or t.dtype)


def _heatmaps(model: ViTPose, frame: torch.Tensor, boxes: torch.Tensor,
              flip_pairs, plain: bool, frame_idx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heatmaps in the head's dtype, or float32 with the flip test;
    packed (M, 8) crop geometry)."""
    crop = crop_normalize_plain if plain else crop_normalize
    with span("evt.pose.sample"):
        x, geo = crop(frame, boxes, IMAGE_SIZE, compute_dtype(model), frame_idx)
    heat = vitpose_forward(model, x, plain=plain)
    if flip_pairs is not None:
        # flip test: forward the mirrored crop, un-flip, average
        flipped = vitpose_forward(model, x.flip(2), plain=plain).float()
        heat = 0.5 * (heat.float() + flip_back_heatmaps(flipped, flip_pairs))
    return heat, geo


def pose_heatmaps(model: ViTPose, frame: torch.Tensor, boxes: torch.Tensor, *,
                  flip_pairs: Optional[Sequence[Sequence[int]]] = None,
                  plain: bool = False, frame_idx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Geometry]:
    """Crop, sample and forward every box: ((M, K, 64, 48) float32 heatmaps,
    crop geometry).  Tensors must already be on the model's device.
    ``plain=True`` runs the kernels' plain versions on any device."""
    heat, geo = _heatmaps(model, frame, boxes, flip_pairs, plain, frame_idx)
    return heat.float(), geometry_views(geo)


@torch.no_grad()
def pose_step(model: ViTPose, frame: ArrayLike, boxes: ArrayLike, mask: ArrayLike, *,
              flip_pairs: Optional[Sequence[Sequence[int]]] = None,
              device=None, plain: bool = False,
              frame_idx: Optional[ArrayLike] = None) -> torch.Tensor:
    """Pose estimation for up to M people on one frame, or on a stack.

    Args:
      model: a serving copy of ViTPose on ``device``.
      frame: (H, W, 3) uint8 RGB frame (numpy or tensor), or a stack
        (S, H, W, 3) with ``frame_idx``.
      boxes: (M, 4) float32 [x1, y1, x2, y2] frame-local boxes.
      mask: (M,) bool; False slots are padding.
      frame_idx: (M,) int32, which frame of the stack each box is in.
      device: where to run; default: the frame's device if it is a tensor,
        else CUDA (raises if there is none).
      plain: run every kernel's plain version, on any device (for checks).
    Returns:
      (M, K, 3) float32 keypoints as (y, x, score) in frame coordinates;
      masked slots are all-zero.
    """
    device = resolve_device(device, frame)
    if model.backbone.pos_embed.device != device:
        raise ValueError(f"model is on {model.backbone.pos_embed.device}, step on {device}")
    with span("evt.pose.step"):
        frame = _to(frame, device)
        boxes = _to(boxes, device, torch.float32)
        mask = _to(mask, device, torch.bool)
        if frame_idx is not None:
            frame_idx = _to(frame_idx, device, torch.int32)
        heat, geo = _heatmaps(model, frame, boxes, flip_pairs, plain, frame_idx)
        # decode with the padded crop's center (w//2, h//2) and size (w, h)
        with span("evt.pose.decode"):
            return (decode_keypoints_plain if plain else decode_keypoints)(heat, geo, mask)


def pose_multi_frame(model: ViTPose, frames: ArrayLike, boxes: ArrayLike,
                     frame_idx: ArrayLike, mask: ArrayLike, *,
                     flip_pairs: Optional[Sequence[Sequence[int]]] = None,
                     device=None, plain: bool = False) -> torch.Tensor:
    """Pose over crops drawn from a stack of frames (JAX's
    ``pipeline/stream.py::_pose_multi_frame``): frames (S, H, W, 3), boxes
    (M, 4) frame-local, frame_idx (M,) the frame of each box -> (M, K, 3)."""
    return pose_step(model, frames, boxes, mask, flip_pairs=flip_pairs, device=device,
                     plain=plain, frame_idx=frame_idx)


def bucket_slots(n: int, min_slots: int = 1, max_slots: int = 64) -> int:
    """Person-slot count for n detections: the next power of two, capped."""
    m = min_slots
    while m < n:
        m *= 2
    return min(m, max_slots)
