"""VitInference: the public orchestrator, on the card.

Port of ``easy_vitpose_tpu/pipeline/inference.py`` (API-compatible with the
reference's single public class, easy_ViTPose/inference.py:51-337): the
same constructor arguments, ``inference(img) -> {id: (K, 3) ndarray of (y,
x, score)}``, ``draw()``, ``reset()`` and the classmethod ``postprocess``.

* ``device`` is a torch device and defaults to CUDA (``kernels.resolve_device``:
  raises when there is none; pass ``device="cpu"`` for the CPU, where every
  kernel's plain version runs).
* Weights: a JAX-format ``.npz`` (``utils/checkpoint.py``, carried across by
  ``convert.from_jax.state_dict_from_jax``) or a reference ``.pth``; the
  serving copy is ``models.vitpose.serving_copy`` at ``dtype`` fp32, bf16 or
  int8.  The detector runs in bf16 when the pose dtype is bf16 or int8.
* A detection frame in image mode (and with ``single_pose``) is one
  program (``pipeline/fused_detect.py::detect_pose``), replayed on the card
  as one CUDA graph (``pipeline/graphs.py``, JAX's ``detect_pose_jit``): the
  frame goes up through pinned memory, the graph is replayed, and the host
  waits once, for the one fetch of (packed detections, keypoints).  The
  tracker then runs on the host.  Video mode with a tracker detects (a
  graph of ``detect_frame_core``), fetches, tracks and then poses the
  tracker's boxes (the pose step, eager), as in JAX.
* ``inference_pipelined`` / ``flush``: video frames one frame late, the
  detector of frame t queued before frame t-1's pose is fetched.
  ``inference_batched`` / ``select_frame_state``: a window of F frames as
  one batched detector program and one multi-frame pose step.
* ``plain=True`` runs every kernel's plain version on the card, eagerly
  (for checks).
* ViTPose+ (``cli/convert.py plus``): ``task=`` picks a task of a
  multi-task ``.npz``; ``convert/vitpose_plus.py::select_task`` splices
  its expert slice and head into a single-task tree, which then serves
  through the same blocks and kernels as any checkpoint.  A task sets the
  dataset (its skeleton and keypoint count).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import (DETC_TO_YOLO_YOLOC, NUM_KEYPOINTS, get_model_config,
                       infer_dataset_by_path)
from ..detect.yolo import to_device
from ..kernels import resolve_device
from ..models.vitpose import ViTPose, serving_copy
from ..skeletons import joints_dict
from ..track.sort import Sort, track_and_cap
from .pose_step import bucket_slots, pose_multi_frame, pose_step

__all__ = ["VitInference"]

YOLO_CONF_THRESHOLD = 0.35   # reference easy_ViTPose/inference.py:241
SERVING = {"fp32": "fp32", "float32": "fp32", "bf16": "bf16", "bfloat16": "bf16",
           "int8": "int8", "w8a8": "int8"}


def load_pose_model(path: str, cfg, dtype: str, device: torch.device,
                    task: Optional[str] = None, dataset: Optional[str] = None) -> ViTPose:
    """The serving copy (``dtype`` fp32, bf16 or int8) on ``device`` of a
    checkpoint (:func:`load_float_model`); the copy (the int8
    quantisation, the casts) is made on ``device``."""
    net = load_float_model(path, cfg, task=task, dataset=dataset).to(device)
    return serving_copy(net, SERVING[dtype])


def load_float_model(path: str, cfg, task: Optional[str] = None,
                     dataset: Optional[str] = None) -> ViTPose:
    """The float32 ``ViTPose`` on the CPU of a JAX-format ``.npz`` or a
    reference ``.pth`` checkpoint (:func:`model_from_params`)."""
    if path.endswith(".pth"):
        from ..convert.vitpose_torch import load_torch_checkpoint
        if task is not None:
            raise ValueError(TASK_NEEDS_PLUS)
        return _holding(cfg, load_torch_checkpoint(path, cfg))
    if path.endswith(".npz"):
        from ..utils.checkpoint import load_params
        return model_from_params(load_params(path), cfg, task=task, dataset=dataset)
    raise ValueError(f"unsupported checkpoint format: {path}")


TASK_NEEDS_PLUS = "task= requires a multi-task (ViTPose+) checkpoint from 'cli/convert plus'"


def model_from_params(params, cfg, task: Optional[str] = None,
                      dataset: Optional[str] = None) -> ViTPose:
    """The float32 ``ViTPose`` on the CPU of a JAX params tree.  A
    multi-task ViTPose+ tree gives ``task`` (default ``dataset``, else
    ``cfg.dataset``), spliced by ``convert/vitpose_plus.py::select_task``;
    ``task`` with a single-task tree raises ``ValueError``."""
    from ..convert.from_jax import state_dict_from_jax
    from ..convert.vitpose_plus import is_plus_params, select_task
    if is_plus_params(params):
        params = select_task(params, task or dataset or cfg.dataset)
    elif task is not None:
        raise ValueError(TASK_NEEDS_PLUS)
    return _holding(cfg, state_dict_from_jax(params, cfg))


def _holding(cfg, sd) -> ViTPose:
    """A ``ViTPose`` whose tensors are ``sd``'s: built on the meta device, so
    no random init is spent on weights that the state dict replaces (about
    a second at ViT-B); each BN's step counter is made by its loader."""
    with torch.device("meta"):
        net = ViTPose(cfg)
    net.load_state_dict(sd, assign=True)
    return net.eval()


class VitInference:
    def __init__(self, model: str,
                 yolo: Optional[str] = None,
                 model_name: Optional[str] = None,
                 det_class: Optional[str] = None,
                 dataset: Optional[str] = None,
                 yolo_size: Optional[int] = 320,
                 device=None,
                 is_video: bool = False,
                 single_pose: bool = False,
                 yolo_step: int = 1,
                 dtype: str = "fp32",
                 max_people: int = 64,
                 model_cfg=None,
                 flip_test: bool = False,
                 fixed_slots: Optional[int] = None,
                 yolo_rect: Optional[bool] = None,
                 task: Optional[str] = None,
                 smooth: bool = False,
                 smooth_params: Optional[dict] = None,
                 tracker: str = "sort",
                 single_dispatch: Optional[bool] = None,
                 plain: bool = False):
        if not os.path.exists(model):
            raise FileNotFoundError(f"The model file {model} does not exist")
        if yolo is not None and not os.path.exists(yolo):
            raise FileNotFoundError(f"The YOLO model {yolo} does not exist")
        if dtype not in SERVING:
            raise ValueError(f"dtype must be one of {sorted(SERVING)}, got {dtype!r}")
        if tracker not in ("sort", "bytetrack"):
            raise ValueError(f"tracker must be 'sort' or 'bytetrack', got {tracker!r}")
        if fixed_slots is not None and not 0 < fixed_slots <= max_people:
            raise ValueError(f"fixed_slots must be in 1..max_people, got {fixed_slots}")
        if model_name not in (None, "s", "b", "l", "h"):
            raise ValueError(f"The model name {model_name} is not valid")
        self.device = resolve_device(device)
        self.plain = plain

        self.yolo_size = yolo_size
        self.yolo_step = yolo_step
        self.is_video = is_video
        # One-Euro smoothing of each track's keypoints across frames (video only)
        self.smooth = bool(smooth) and is_video
        self._smooth_kw = dict(smooth_params or {})
        self._smoothers = {}
        self.single_pose = single_pose
        self.max_people = max_people
        # detector + pose as one queue of launches on detection frames;
        # default on where it is exact (no tracker), opt-in in video mode,
        # where it poses the raw detection boxes instead of the tracker's
        if single_dispatch is None:
            single_dispatch = not (is_video and not single_pose)
        self.single_dispatch = single_dispatch
        self.tracker_type = tracker
        # slots: fixed_slots pins them; video mode ratchets a grow-only
        # high-water bucket; image mode buckets to powers of two
        self.fixed_slots = fixed_slots
        self._slots_highwater = 0

        # a multi-task checkpoint's task is its dataset (skeleton and K)
        if task is not None and dataset is None:
            dataset = task
        if dataset is None:
            dataset = infer_dataset_by_path(model)
        if dataset not in NUM_KEYPOINTS:
            raise ValueError(f"invalid dataset {dataset!r}")
        self.dataset = dataset
        if det_class is None:
            det_class = "animals" if dataset in ("ap10k", "apt36k") else "human"
        self.det_class = det_class
        self.yolo_classes = DETC_TO_YOLO_YOLOC[det_class]

        if model_cfg is not None:
            self.cfg = model_cfg
        elif model_name is None:
            raise ValueError("model_name ('s'|'b'|'l'|'h') is required")
        else:
            self.cfg = get_model_config(dataset, model_name)
        if flip_test:
            from ..skeletons import flip_pairs
            self._flip_pairs = flip_pairs(dataset)
        else:
            self._flip_pairs = None

        # --- weights ---
        self.serving_dtype = SERVING[dtype]
        self.quant = self.serving_dtype == "int8"
        self.compute_dtype = (torch.float32 if self.serving_dtype == "fp32"
                              else torch.bfloat16)
        self._model = load_pose_model(model, self.cfg, self.serving_dtype, self.device,
                                      task=task, dataset=dataset)

        # --- detector ---
        self._detector = None
        if yolo is not None:
            from ..detect.yolo import YoloDetector
            from ..track.bytetrack import LOW_THRESHOLD
            # video default: the minimal-rectangle letterbox; images: square
            if yolo_rect is None:
                yolo_rect = is_video
            # bytetrack needs the low-confidence band past the NMS gate
            det_conf = LOW_THRESHOLD if self.tracker_type == "bytetrack" else 0.25
            self._detector = YoloDetector(yolo, imgsz=yolo_size, classes=self.yolo_classes,
                                          conf=det_conf, dtype=self.compute_dtype,
                                          device=self.device, rect=yolo_rect, plain=plain)

        self.reset()

        # state for draw()
        self.save_state = True
        self._img = None
        self._yolo_res = None
        self._tracker_res = None
        self._keypoints = None
        self._scores_bbox = {}

    # ------------------------------------------------------------------ api

    def set_yolo_step(self, step: int):
        """Retune the detection cadence mid-stream; max_age follows
        yolo_step so tracks coast across skipped detections, without
        dropping live tracks."""
        step = max(1, int(step))
        if step == self.yolo_step:
            return
        self.yolo_step = step
        if self.tracker is not None:
            self.tracker.max_age = step
            self.tracker.min_hits = 3 if step == 1 else 1
            if hasattr(self.tracker, "det_stride"):
                self.tracker.det_stride = step

    @property
    def has_detector(self) -> bool:
        """True when a YOLO checkpoint was loaded (without one, only the
        precomputed-``bboxes`` inference path is available)."""
        return self._detector is not None

    def reset(self):
        """Reset per-video state (frame counter + tracker); reference :174-185."""
        min_hits = 3 if self.yolo_step == 1 else 1
        use_tracker = self.is_video and not self.single_pose
        if not use_tracker:
            self.tracker = None
        elif self.tracker_type == "bytetrack":
            from ..track.bytetrack import ByteTrack
            self.tracker = ByteTrack(max_age=self.yolo_step, min_hits=min_hits,
                                     iou_threshold=0.3, high_thresh=YOLO_CONF_THRESHOLD,
                                     det_stride=self.yolo_step)
        else:
            self.tracker = Sort(max_age=self.yolo_step, min_hits=min_hits, iou_threshold=0.3)
        self._smoothers = {}
        self.frame_counter = 0
        # new video, new high-water marks
        self._slots_highwater = 0
        self._batched_slots = 0
        self._pipe_pending = None  # (img, frame on the device, detection handle)

    @classmethod
    def postprocess(cls, heatmaps: np.ndarray, org_w: int, org_h: int) -> np.ndarray:
        """Heatmaps -> (N, K, 3) (y, x, score), on the CPU; reference :187-205."""
        from ..ops.decode import keypoints_from_heatmaps_udp
        n = heatmaps.shape[0]
        center = torch.from_numpy(np.repeat(np.array([[org_w // 2, org_h // 2]], np.float32),
                                            n, 0))
        scale = torch.from_numpy(np.repeat(np.array([[org_w, org_h]], np.float32), n, 0))
        pts, prob = keypoints_from_heatmaps_udp(
            torch.as_tensor(np.asarray(heatmaps, np.float32)), center, scale)
        return np.concatenate([pts.numpy()[:, :, ::-1], prob.numpy()], axis=2)

    def _detect_due(self) -> bool:
        """Detection cadence for this frame (reference :235-236)."""
        return (self.tracker is None
                or self.frame_counter % self.yolo_step == 0
                or self.frame_counter < 3)

    def _gate(self) -> float:
        """The detection confidence gate: 0.35 (reference
        inference.py:240-241), the tracker's low threshold with ByteTrack."""
        if self.tracker is not None and self.tracker_type == "bytetrack":
            return self.tracker.low_thresh
        return YOLO_CONF_THRESHOLD

    def _filter_dets(self, results: np.ndarray) -> np.ndarray:
        """Detector rows [x1,y1,x2,y2,conf,cls] -> (N, 5) tracker candidates
        above the gate."""
        return results[results[:, 4] > self._gate()][:, :5]

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        return to_device(img, self.device)

    def _pose(self, frame_dev: torch.Tensor, boxes: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """The pose step on (M, 4) host boxes: (M, K, 3) keypoints, fetched."""
        out = pose_step(self._model, frame_dev, to_device(boxes, self.device),
                        to_device(mask, self.device), flip_pairs=self._flip_pairs,
                        plain=self.plain)
        return out.cpu().numpy()

    def inference(self, img: np.ndarray,
                  bboxes: Optional[np.ndarray] = None) -> Dict[Any, np.ndarray]:
        """Detect (or take given boxes) -> track -> pose. img is RGB HWC uint8.

        Returns {person_id: (K, 3) float32 (y, x, score)}.
        """
        if (bboxes is None and self.single_dispatch
                and self._detector is not None and self._detect_due()):
            return self._inference_fused(img)
        res_pd = np.empty((0, 5), np.float32)
        results = None
        # upload the frame once; detector and pose step share the buffer
        frame_dev = self._upload(img)
        if bboxes is not None:
            res_pd = np.asarray(bboxes, np.float32).reshape(-1, 5)
        elif self._detector is not None and self._detect_due():
            results = self._detector(frame_dev, frame_hw=img.shape[:2])
            if len(results):
                res_pd = self._filter_dets(results)
        self.frame_counter += 1
        return self._track_and_pose(img, frame_dev, res_pd, results)

    def _inference_fused(self, img: np.ndarray) -> Dict[Any, np.ndarray]:
        """A detection frame as one queue of launches and one fetch; the
        keypoints are keyed to tracks after the fetch."""
        from ..detect.yolo import YoloDetector
        from .fused_detect import detect_pose
        det = self._detector
        frame_dev = self._upload(img)
        H, W = img.shape[:2]
        geom = det.geometry((H, W))
        # the slot count is chosen before this frame's detections are known:
        # the grow-only high-water bucket of past frames; rows beyond it
        # take the fallback pose step below
        if self.fixed_slots is not None:
            slots = self.fixed_slots
        else:
            slots = max(self._slots_highwater, bucket_slots(1, max_slots=self.max_people))
        gate = self._gate()

        def program(frame):
            return detect_pose(det.model, self._model, frame, geom, det.spec, det.imgsz,
                               det.classes, det.conf, det.iou, det.max_det, det.dtype, slots,
                               gate, flip_pairs=self._flip_pairs, plain=self.plain)

        if det.graphed:
            packed_dev, kpts_dev = det.graphs.run(
                ("detect_pose", tuple(frame_dev.shape), slots, gate), program, frame_dev)
        else:
            packed_dev, kpts_dev = program(frame_dev)
        # the one fetch of the frame: both outputs in one copy
        both = torch.cat([packed_dev.reshape(-1), kpts_dev.reshape(-1)]).cpu().numpy()
        packed = both[:packed_dev.numel()].reshape(packed_dev.shape)
        kpts = both[packed_dev.numel():].reshape(kpts_dev.shape)
        self.frame_counter += 1

        results = YoloDetector.unpack(packed, (H, W))
        res_pd0 = self._filter_dets(results)
        # pose slot j is res_pd0 row j: the kept rows are a score-sorted
        # prefix, so the gate keeps a prefix and the indices line up
        rows, ids, scores, emitted_di = self._track_boxes(res_pd0)
        if self.fixed_slots is None:
            self._slots_highwater = max(
                self._slots_highwater,
                bucket_slots(max(len(res_pd0), len(rows)), max_slots=self.max_people))

        frame_keypoints: Dict[Any, np.ndarray] = {}
        scores_bbox: Dict[Any, float] = {}
        fallback = []          # rows emitted without an in-slot detection
        for i, (pid, score) in enumerate(zip(ids, scores)):
            di = int(emitted_di[i])
            if 0 <= di < slots:
                frame_keypoints[pid] = kpts[di]
            else:
                fallback.append(i)
            scores_bbox[pid] = score
        if fallback:
            # coasting tracks, or detections beyond the slot count: one
            # pose step on their (tracker) boxes
            M = bucket_slots(len(fallback), max_slots=self.max_people)
            boxes_p = np.zeros((M, 4), np.float32)
            mask = np.zeros((M,), bool)
            for j, i in enumerate(fallback[:M]):
                boxes_p[j] = rows[i, :4]
                mask[j] = True
            out = self._pose(frame_dev, boxes_p, mask)
            for j, i in enumerate(fallback[:M]):
                frame_keypoints[ids[i]] = out[j]
        if self.smooth:
            frame_keypoints = self._apply_smoothing(frame_keypoints)

        if self.save_state:
            self._img = img
            self._yolo_res = results
            self._tracker_res = (self._saved_bboxes(rows, img.shape[:2]), ids, scores)
            self._keypoints = frame_keypoints
            self._scores_bbox = scores_bbox
        return frame_keypoints

    def inference_pipelined(self, img: np.ndarray) -> Optional[Dict[Any, np.ndarray]]:
        """Pipelined video inference: returns the keypoints of the PREVIOUS
        frame (None on the first call; :meth:`flush` drains the last one).

        The order hides the detector of frame t under frame t-1's pose:
        fetch detect(t-1) -> track on the host -> queue pose(t-1) -> queue
        detect(t) -> fetch pose(t-1).  Results, ``draw()`` and state are
        those of :meth:`inference`, one frame late."""
        frame_dev = self._upload(img)
        out_prev = None
        if self._pipe_pending is not None:
            prev_img, prev_dev, det_h = self._pipe_pending
            res_pd, results = self._fetched_dets(det_h, prev_img.shape[:2])
            det_t = self._dispatch_detect_async(frame_dev, img.shape[:2])
            out_prev = self._track_and_pose(prev_img, prev_dev, res_pd, results)
        else:
            det_t = self._dispatch_detect_async(frame_dev, img.shape[:2])
        self._pipe_pending = (img, frame_dev, det_t)
        return out_prev

    def flush(self) -> Optional[Dict[Any, np.ndarray]]:
        """Drain the pipelined stream: process and return the last frame."""
        if self._pipe_pending is None:
            return None
        prev_img, prev_dev, det_h = self._pipe_pending
        self._pipe_pending = None
        res_pd, results = self._fetched_dets(det_h, prev_img.shape[:2])
        return self._track_and_pose(prev_img, prev_dev, res_pd, results)

    def _fetched_dets(self, det_h, hw):
        """Fetch a queued detection (None: no detection this frame) ->
        (tracker candidates, detector rows or None)."""
        res_pd = np.empty((0, 5), np.float32)
        results = None
        if det_h is not None:
            results = self._detector.unpack(det_h.cpu().numpy(), hw)
            if len(results):
                res_pd = self._filter_dets(results)
        return res_pd, results

    def _dispatch_detect_async(self, frame_dev, hw):
        due = self._detector is not None and self._detect_due()
        self.frame_counter += 1
        return self._detector.detect_async(frame_dev, frame_hw=hw) if due else None

    def inference_batched(self, frames, bboxes_per_frame=None) -> list:
        """Offline batched video inference: F consecutive same-size frames ->
        F result dicts from two programs (one batched detector program, one
        multi-frame pose step) instead of 2F.

        Semantics are those of calling :meth:`inference` frame by frame: the
        same detection cadence, confidence gate, tracker evolution, score cap
        and flip test, so track IDs line up with the sequential path.  The
        detector runs at batch F and the pose step over the stack, so values
        may differ from the per-frame path by float noise.

        Args:
          frames: sequence of (H, W, 3) uint8 RGB frames (same size).
          bboxes_per_frame: optional list of (N_i, 5) [x1, y1, x2, y2, conf]
            arrays instead of detection.
        Returns:
          a list of {person_id: (K, 3) float32 (y, x, score)}, one per frame;
          ``draw()`` state is left at the last frame of the window
          (:meth:`select_frame_state` points it at another).
        """
        frames = list(frames)
        F = len(frames)
        if F == 0:
            return []
        stack = np.stack(frames)
        frames_dev = self._upload(stack)
        H, W = stack.shape[1:3]

        # detection cadence per frame, from the running counter
        due = []
        for _ in range(F):
            due.append(bboxes_per_frame is None
                       and self._detector is not None and self._detect_due())
            self.frame_counter += 1
        dets = None
        if any(due):
            h = self._detector.detect_batch_async(frames_dev)
            dets = self._detector.unpack_batch(h.cpu().numpy(), (H, W))

        # host tracking, in frame order (the sequential path's evolution)
        per_frame = []
        all_boxes, all_fidx = [], []
        for i in range(F):
            results = None
            res_pd = np.empty((0, 5), np.float32)
            if bboxes_per_frame is not None:
                res_pd = np.asarray(bboxes_per_frame[i], np.float32).reshape(-1, 5)
            elif due[i]:
                results = dets[i]
                if len(results):
                    res_pd = self._filter_dets(results)
            res_pd, ids, scores, _ = self._track_boxes(res_pd)
            per_frame.append((res_pd, ids, scores, results))
            for row in res_pd:
                all_boxes.append(row[:4])
                all_fidx.append(i)

        outputs = [dict() for _ in range(F)]
        nb = len(all_boxes)
        if nb:
            # grow-only slot high-water mark over the window
            self._batched_slots = max(self._batched_slots,
                                      bucket_slots(nb, max_slots=F * self.max_people))
            M = self._batched_slots
            boxes = np.zeros((M, 4), np.float32)
            fidx = np.zeros((M,), np.int32)
            mask = np.zeros((M,), bool)
            boxes[:nb] = np.stack(all_boxes)
            boxes[:nb, 0::2] = np.clip(boxes[:nb, 0::2], 0, W)
            boxes[:nb, 1::2] = np.clip(boxes[:nb, 1::2], 0, H)
            fidx[:nb] = all_fidx
            mask[:nb] = True
            out = pose_multi_frame(self._model, frames_dev, to_device(boxes, self.device),
                                   to_device(fidx, self.device), to_device(mask, self.device),
                                   flip_pairs=self._flip_pairs, plain=self.plain).cpu().numpy()
            k = 0
            for i in range(F):
                _, ids, _, _ = per_frame[i]
                for pid in ids:
                    outputs[i][pid] = out[k]
                    k += 1
        if self.smooth:
            # in frame order: the sequential path's filter evolution
            outputs = [self._apply_smoothing(o) for o in outputs]

        if self.save_state:
            self._window_states = []
            for i in range(F):
                res_pd, ids, scores, results = per_frame[i]
                self._window_states.append(
                    (frames[i], results,
                     (self._saved_bboxes(res_pd, frames[i].shape[:2]), ids, scores),
                     outputs[i], dict(zip(ids, scores))))
            self.select_frame_state(F - 1)
        return outputs

    def select_frame_state(self, i: int):
        """Point ``draw()`` at frame ``i`` of the last
        :meth:`inference_batched` window."""
        (self._img, self._yolo_res, self._tracker_res, self._keypoints,
         self._scores_bbox) = self._window_states[i]

    @staticmethod
    def _saved_bboxes(rows, hw):
        """The boxes kept for ``draw()``: the reference inflates each rounded
        box by 10 px, clipped to the frame, before it stores it (reference
        inference.py:258-263), so ``draw()`` shows the crop rectangles."""
        from ..ops.preprocess import PAD_BBOX
        H, W = hw
        b = np.asarray(rows[:, :4]).round().astype(int)
        if len(b):
            b[:, [0, 2]] = np.clip(b[:, [0, 2]] + [-PAD_BBOX, PAD_BBOX], 0, W)
            b[:, [1, 3]] = np.clip(b[:, [1, 3]] + [-PAD_BBOX, PAD_BBOX], 0, H)
        return b

    def _apply_smoothing(self, kps):
        """Per-track One-Euro smoothing (y/x smoothed, scores pass through)."""
        from ..ops.one_euro import apply_track_smoothing
        return apply_track_smoothing(kps, self._smoothers, **self._smooth_kw)

    def _track_boxes(self, res_pd):
        """The host tracking stage: sanitize -> tracker update -> finite
        filter -> score cap.  Returns (rows, ids, scores, det_idx), where
        ``det_idx`` maps each output row to its index in ``res_pd`` (-1 for
        a coasting track with no detection this frame)."""
        rows, det_idx = track_and_cap(self.tracker, res_pd, self.fixed_slots or self.max_people)
        ids = (rows[:, 5].astype(int).tolist() if self.tracker is not None
               else list(range(len(rows))))
        return rows, ids, rows[:, 4].tolist(), det_idx

    def _track_and_pose(self, img, frame_dev, res_pd, results) -> Dict[Any, np.ndarray]:
        res_pd, ids, scores, _ = self._track_boxes(res_pd)
        frame_keypoints: Dict[Any, np.ndarray] = {}
        scores_bbox: Dict[Any, float] = {}
        n = len(res_pd)
        if n:
            if self.fixed_slots is not None:
                M = self.fixed_slots
            elif self.is_video:
                self._slots_highwater = max(self._slots_highwater,
                                            bucket_slots(n, max_slots=self.max_people))
                M = self._slots_highwater
            else:
                M = bucket_slots(n, max_slots=self.max_people)
            boxes_p = np.zeros((M, 4), np.float32)
            boxes_p[:n] = res_pd[:n, :4]
            mask = np.zeros((M,), bool)
            mask[:n] = True
            out = self._pose(frame_dev, boxes_p, mask)
            for i, (pid, score) in enumerate(zip(ids, scores)):
                frame_keypoints[pid] = out[i]
                scores_bbox[pid] = score
        if self.smooth:
            frame_keypoints = self._apply_smoothing(frame_keypoints)

        if self.save_state:
            self._img = img
            self._yolo_res = results
            self._tracker_res = (self._saved_bboxes(res_pd, img.shape[:2]), ids, scores)
            self._keypoints = frame_keypoints
            self._scores_bbox = scores_bbox
        return frame_keypoints

    def draw(self, show_yolo: bool = True, show_raw_yolo: bool = False,
             confidence_threshold: float = 0.5) -> np.ndarray:
        """Render stored keypoints/bboxes; returns RGB image (reference :283-312)."""
        from ..utils.visualization import draw_bboxes, draw_points_and_skeleton
        img = np.array(self._img)[..., ::-1].copy()  # RGB -> BGR for cv2
        bboxes, ids, scores = self._tracker_res
        if show_raw_yolo or (self.tracker is None and show_yolo):
            if self._yolo_res is not None and len(self._yolo_res):
                r = self._yolo_res
                img = draw_bboxes(img, r[:, :4].astype(int), range(len(r)), r[:, 4].tolist())
        if show_yolo and self.tracker is not None:
            img = draw_bboxes(img, bboxes, ids, scores)
        for idx, k in self._keypoints.items():
            img = draw_points_and_skeleton(
                img.copy(), k, joints_dict()[self.dataset]["skeleton"],
                person_index=idx,
                points_color_palette="gist_rainbow",
                skeleton_color_palette="jet",
                points_palette_samples=10,
                confidence_threshold=confidence_threshold)
        return img[..., ::-1]  # back to RGB
