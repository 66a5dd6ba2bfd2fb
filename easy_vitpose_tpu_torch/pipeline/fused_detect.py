"""Detection frames as one queue of work on the card: detector + pose.

Port of ``easy_vitpose_tpu/pipeline/fused_detect.py``.
In JAX, ``detect_pose_jit`` is one jitted program and the host fetches its
two outputs once.  On the card the same holds as one stream of launches that
the host queues without waiting on any of them:

    frame -> D1 letterbox, YOLO, DFL decode, class gate, stable sort, D2 NMS
    -> packed rows (score-sorted, valid prefix) -> the first ``slots`` rows
    become pose slots (masked at the pipeline's confidence gate) -> the pose
    step (K3, K2 or K1, the fused decode) -> keypoints

and the host fetches (packed, keypoints) once.  The tracker runs on the
host after that fetch and keys the keypoints to tracks.  Semantics and the
slot policy are JAX's: see ``pipeline/inference.py::VitInference``.
:func:`detect_pose_multi` is the multi-stream tick: S frames through the
batched detector and one multi-frame pose step, slot ``s * slots + j``
being detection j of stream s.  On the card the pipelines replay each as
one CUDA graph (``pipeline/graphs.py``), the counterpart of JAX's
``detect_pose_jit`` and ``detect_pose_multi_jit``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..detect.yolo import Yolo, YoloSpec, detect_batch_core, detect_frame_core
from ..models.vitpose import ViTPose
from .pose_step import pose_step


def _slot_rows(packed: torch.Tensor, slots: int, max_det: int) -> torch.Tensor:
    """First ``slots`` packed detection rows along the last-but-one axis,
    zero-padded when ``slots > max_det`` (the grow-only slot bucket rounds
    up to powers of two, so it can exceed the detector's max_det; zero rows
    fail the validity gate of :func:`_slot_mask`, so padded slots stay
    masked)."""
    if slots <= max_det:
        return packed[..., :slots, :]
    return F.pad(packed, (0, 0, 0, slots - max_det))


@functools.lru_cache(maxsize=None)
def _frame_bounds(W: int, H: int, device: torch.device) -> torch.Tensor:
    """[W, H, W, H] float32, made once per frame size and device."""
    return torch.tensor([W, H, W, H], dtype=torch.float32).to(device)


def _slot_mask(rows: torch.Tensor, W: int, H: int, gate: float):
    """Clip + confidence gate + sanitize for pose slots: the host path's
    unpack clip (``YoloDetector.unpack``) and ``sanitize_detections``
    (``track/sort.py``) on the device.  Returns (boxes, mask)."""
    wh = _frame_bounds(W, H, rows.device)
    boxes = torch.minimum(torch.clamp(rows[:, :4], min=0.0), wh)
    mask = ((rows[:, 6] > 0)
            & (rows[:, 4] > gate)
            & torch.isfinite(boxes).all(dim=1)
            & (boxes[:, 2] > boxes[:, 0])
            & (boxes[:, 3] > boxes[:, 1]))
    return boxes, mask


@torch.no_grad()
def detect_pose(yolo: Yolo, model: ViTPose, frame: torch.Tensor, geom, spec: YoloSpec,
                imgsz: int, classes, conf_nms: float, iou_t: float, max_det: int, det_dtype,
                slots: int, gate: float, flip_pairs=None, plain: bool = False):
    """frame (H, W, 3) uint8 on the device -> (packed (max_det, 7),
    keypoints (slots, K, 3)), both on the device, queued without a host
    wait.  Pose slot i is packed row i: valid, above ``gate``, clipped to the
    frame and non-degenerate; masked slots are zero.  ``plain=True`` runs
    every kernel's plain version (for checks)."""
    packed = detect_frame_core(yolo, frame, geom, spec, imgsz, classes, conf_nms, iou_t,
                               max_det, det_dtype, plain=plain)
    H, W = frame.shape[0], frame.shape[1]
    rows = _slot_rows(packed, slots, max_det)
    boxes, mask = _slot_mask(rows, W, H, gate)
    kpts = pose_step(model, frame, boxes, mask, flip_pairs=flip_pairs, plain=plain)
    return packed, kpts


@functools.lru_cache(maxsize=None)
def _slot_frames(S: int, slots: int, device: torch.device) -> torch.Tensor:
    """(S * slots,) int32 ``arange // slots``: the stream of each slot."""
    return (torch.arange(S * slots, dtype=torch.int32) // slots).to(device)


@torch.no_grad()
def detect_pose_multi(yolo: Yolo, model: ViTPose, frames: torch.Tensor, geom, spec: YoloSpec,
                      classes, conf_nms: float, iou_t: float, max_det: int, det_dtype,
                      slots: int, gate: float, flip_pairs=None, plain: bool = False):
    """The multi-stream tick: frames (S, H, W, 3) uint8 on the device ->
    (packed (S, max_det, 7), keypoints (S * slots, K, 3)), queued without a
    host wait.  The batched detector runs once over the stack; each
    stream's first ``slots`` packed rows become its block of pose slots
    (slot ``s * slots + j`` is detection j of stream s), gated as in
    :func:`detect_pose`, and one pose step poses them all, each crop from
    its own frame."""
    packed = detect_batch_core(yolo, frames, geom, spec, classes, conf_nms, iou_t, max_det,
                               det_dtype, plain=plain)
    S, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
    rows = _slot_rows(packed, slots, max_det).reshape(S * slots, 7)
    boxes, mask = _slot_mask(rows, W, H, gate)
    kpts = pose_step(model, frames, boxes, mask, flip_pairs=flip_pairs, plain=plain,
                     frame_idx=_slot_frames(S, slots, frames.device))
    return packed, kpts
