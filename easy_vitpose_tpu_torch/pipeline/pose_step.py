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

Given a ViTPose+ serving copy (``models/moe.py::PlusQ8``) and
``tasks``, a task per box as host data, one step poses boxes of mixed tasks:
the host orders the boxes by task and uploads the order with the grouped
GEMM's table (``evt.pose.route``); K3 crops them in that order; each block's
fc2 runs the shared rows over every crop and each task's expert rows over
that task's crops alone; each task's head runs over its crops
(``evt.pose.heads``, an ``evt.pose.head`` a task) and the decode over their
own K maps, and the keypoints go back to box order, (M, K_max, 3) with the
rows past a box's K all zero.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import IMAGE_SIZE
from ..kernels import resolve_device
from ..models.head import heads_forward
from ..models.moe import PlusQ8, Routing, routed_backbone
from ..models.vitpose import ViTPose, compute_dtype, vitpose_forward
from ..ops.affine import flip_back_heatmaps
from ..ops.decode import decode_keypoints, decode_keypoints_plain, decode_task_groups
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
              frame_idx: Optional[ArrayLike] = None,
              tasks: Optional[Union[np.ndarray, Sequence[int]]] = None) -> torch.Tensor:
    """Pose estimation for up to M people on one frame, or on a stack.

    Args:
      model: a serving copy of ViTPose on ``device``, or of ViTPose+
        (``models/moe.py::PlusQ8``) with ``tasks``.
      frame: (H, W, 3) uint8 RGB frame (numpy or tensor), or a stack
        (S, H, W, 3) with ``frame_idx``.
      boxes: (M, 4) float32 [x1, y1, x2, y2] frame-local boxes.
      mask: (M,) bool; False slots are padding.
      frame_idx: (M,) int32, which frame of the stack each box is in.
      device: where to run; default: the frame's device if it is a tensor,
        else CUDA (raises if there is none).
      plain: run every kernel's plain version, on any device (for checks).
      tasks: (M,) int host array (numpy or a list), each box's task, an
        index into ``model.tasks`` (the reference's dataset order); a
        ViTPose+ copy only.  Masked boxes still need a task.
    Returns:
      (M, K, 3) float32 keypoints as (y, x, score) in frame coordinates;
      masked slots are all-zero.  With ``tasks``: (M, K_max, 3), K_max the
      largest K of the model's heads, a box's rows past its task's K zero.
    """
    device = resolve_device(device, frame)
    if isinstance(model, PlusQ8) or tasks is not None:
        return _pose_step_routed(model, frame, boxes, mask, tasks, device, plain, frame_idx,
                                 flip_pairs)
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


def _pose_step_routed(model: PlusQ8, frame, boxes, mask, tasks, device, plain: bool,
                      frame_idx, flip_pairs) -> torch.Tensor:
    if not isinstance(model, PlusQ8) or tasks is None:
        raise ValueError("tasks= goes with a ViTPose+ serving copy (models/moe.py::PlusQ8)")
    if flip_pairs is not None:
        raise ValueError("the flip test is not served on a batch of mixed tasks")
    if isinstance(tasks, torch.Tensor) and tasks.device.type != "cpu":
        raise ValueError("tasks must be host data: reading them from the card would wait on it")
    if model.backbone.pos_embed.device != device:
        raise ValueError(f"model is on {model.backbone.pos_embed.device}, step on {device}")
    Hp, Wp = model.cfg.backbone.patch_shape
    with span("evt.pose.step"):
        frame = _to(frame, device)
        with span("evt.pose.route"):
            routing = Routing(np.asarray(tasks), len(model.tasks), Hp * Wp).to(device)
            boxes = _to(boxes, device, torch.float32).index_select(0, routing.order_t)
            mask = _to(mask, device, torch.bool).index_select(0, routing.order_t)
            if frame_idx is not None:
                frame_idx = _to(frame_idx, device, torch.int32).index_select(0, routing.order_t)
        crop = crop_normalize_plain if plain else crop_normalize
        with span("evt.pose.sample"):
            x, geo = crop(frame, boxes, IMAGE_SIZE, compute_dtype(model), frame_idx)
        with span("evt.pose.backbone"):
            feats = routed_backbone(model, x, routing, plain)
        with span("evt.pose.heads"):
            heats = heads_forward(model.heads, feats.permute(0, 3, 1, 2), routing.slices,
                                  model.tasks)
        with span("evt.pose.decode"):
            kp = decode_task_groups(heats, geo, mask, routing.slices, max(model.num_keypoints),
                                    plain=plain)
            return kp.index_select(0, routing.inverse_t)


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
