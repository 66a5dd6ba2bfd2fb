"""Top-down COCO-format keypoint dataset.

The port's own copy of ``easy_vitpose_tpu/train/dataset.py`` (numpy and
cv2): the same records, augmentation draws in the same order from
``random.Random(seed)``, crops and targets bit for bit, and the same
collate.  cv2 is imported when present, as there; reading an item needs it.

Capability parity with the reference dataset (reference datasets/COCO.py:
24-496): per-instance center/scale records (aspect-fixed, x1.25, pixel_std
200, :318-337), half-body / scale / rotation / flip augmentation
(:264-285), affine crop warp (:288-294), Gaussian heatmap targets
(ops/heatmap.py), COCO result writing for evaluation (:441-496).

Differences (deliberate):
* pycocotools is not required — the COCO JSON is parsed directly;
* standard COCO layout ({root}/annotations/person_keypoints_{ver}.json,
  images in {root}/{ver}/) instead of the reference's custom
  {root}/{ver}/config/config.json layout; an explicit ann_file wins;
* batches are assembled NHWC float32 (the models' input layout) with a background
  prefetch thread; normalization happens on host once per batch.
"""
from __future__ import annotations

import json
import os
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..configs import IMAGENET_MEAN, IMAGENET_STD
from ..ops.affine import (affine_transform_batch, fliplr_joints,
                          get_affine_transform)
from ..ops.heatmap import generate_gaussian_targets_np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

PIXEL_STD = 200  # reference datasets/COCO.py:111


class CocoPoseDataset:
    def __init__(self, root_path: str, data_version: str = "train2017",
                 is_train: bool = True, use_gt_bboxes: bool = True,
                 bbox_path: str = "",
                 ann_file: Optional[str] = None,
                 image_width: int = 192, image_height: int = 256,
                 scale: bool = True, scale_factor: float = 0.35,
                 flip_prob: float = 0.5, rotate_prob: float = 0.5,
                 rotation_factor: float = 45.0, half_body_prob: float = 0.3,
                 use_different_joints_weight: bool = False,
                 heatmap_sigma: float = 3.0,
                 num_joints: int = 17,
                 flip_pairs: Optional[List[List[int]]] = None,
                 upper_body_ids: Optional[List[int]] = None,
                 category_id: int = 1,
                 seed: Optional[int] = None,
                 device_input: bool = False):
        self.root_path = root_path
        self.data_version = data_version
        self.is_train = is_train
        self.use_gt_bboxes = use_gt_bboxes
        self.scale = scale
        self.scale_factor = scale_factor
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.rotation_factor = rotation_factor
        self.half_body_prob = half_body_prob
        self.use_different_joints_weight = use_different_joints_weight
        self.heatmap_sigma = heatmap_sigma
        self.image_size = (image_width, image_height)
        self.aspect_ratio = image_width / image_height
        self.heatmap_size = (image_width // 4, image_height // 4)
        self.num_joints = num_joints
        self.num_joints_half_body = 8
        self.flip_pairs = flip_pairs if flip_pairs is not None else \
            [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
             [15, 16]]
        # COCO-17 upper-body joints (nose..wrists); the reference's 18-joint
        # variant uses ids 0-9 for its own skeleton (datasets/COCO.py:115)
        self.upper_body_ids = upper_body_ids if upper_body_ids is not None \
            else list(range(11))
        # coco joint weights (reference :116-117, 18-joint variant there)
        self.joints_weight = np.ones((num_joints, 1), np.float32)
        # device_input: __getitem__ skips normalization + target rendering
        # and ships the warped uint8 crop + joint coords; the train
        # step renders targets on device (train/step.py
        # render_batch_on_device), fewer host->device bytes and less
        # loader work per sample
        self.device_input = device_input
        self.rng = random.Random(seed)

        if ann_file is None:
            ann_file = os.path.join(
                root_path, "annotations",
                f"person_keypoints_{data_version}.json")
        self.ann_file = ann_file
        self.img_dir = os.path.join(root_path, data_version)
        self.category_id = category_id
        self.data = self._load_annotations()

    # ------------------------------------------------------------- loading

    def _load_annotations(self) -> List[dict]:
        with open(self.ann_file) as f:
            coco = json.load(f)
        images = {im["id"]: im for im in coco["images"]}
        records = []
        for ann in coco.get("annotations", []):
            if ann.get("category_id", 1) != self.category_id:
                continue
            if ann.get("iscrowd", 0):
                continue
            if self.use_gt_bboxes and ann.get("num_keypoints", 0) == 0:
                continue
            im = images[ann["image_id"]]
            w_img, h_img = im["width"], im["height"]
            x, y, w, h = ann["bbox"]
            # clip bbox to image (reference :190-198 semantics)
            x1 = max(0, x)
            y1 = max(0, y)
            x2 = min(w_img - 1, x + max(0, w - 1))
            y2 = min(h_img - 1, y + max(0, h - 1))
            if x2 <= x1 or y2 <= y1:
                continue
            kp = np.array(ann.get("keypoints",
                                  [0] * (self.num_joints * 3)),
                          np.float32).reshape(-1, 3)
            joints = kp[:, :2]
            vis = np.repeat(
                np.clip(kp[:, 2:3], 0, 1), 2, axis=1).astype(np.float32)
            center, scale = self._xywh2cs(x1, y1, x2 - x1, y2 - y1)
            records.append({
                "imgId": ann["image_id"],
                "annId": ann.get("id", -1),
                "imgPath": os.path.join(self.img_dir, im["file_name"]),
                "center": center, "scale": scale,
                "joints": joints, "joints_visibility": vis,
                "bbox": np.array([x1, y1, x2 - x1, y2 - y1], np.float32),
            })
        return records

    def _xywh2cs(self, x, y, w, h):
        """bbox -> center/scale (reference :318-337): fix aspect, /200, x1.25."""
        center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / PIXEL_STD, h / PIXEL_STD], np.float32)
        if center[0] != -1:
            scale = scale * 1.25
        return center, scale

    def _half_body_transform(self, joints, joints_vis):
        """(reference :339-382)."""
        upper, lower = [], []
        for j in range(self.num_joints):
            if joints_vis[j, 0] > 0:
                (upper if j in self.upper_body_ids else lower).append(joints[j])
        if self.rng.random() < 0.5 and len(upper) > 2:
            selected = upper
        else:
            selected = lower if len(lower) > 2 else upper
        if len(selected) < 2:
            return None, None
        sel = np.array(selected, np.float32)
        center = sel.mean(0)[:2]
        lt, rb = sel.min(0), sel.max(0)
        w, h = rb[0] - lt[0], rb[1] - lt[1]
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        return center, np.array([w / PIXEL_STD, h / PIXEL_STD],
                                np.float32) * 1.5

    # ------------------------------------------------------------ getitem

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int):
        rec = self.data[index]
        img = cv2.imread(rec["imgPath"], cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"Fail to read {rec['imgPath']}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

        joints = rec["joints"].copy()
        joints_vis = rec["joints_visibility"].copy()
        c = rec["center"].copy()
        s = rec["scale"].copy()
        r = 0.0

        if self.is_train:
            if (self.half_body_prob
                    and self.rng.random() < self.half_body_prob
                    and joints_vis[:, 0].sum() > self.num_joints_half_body):
                ch, sh = self._half_body_transform(joints, joints_vis)
                if ch is not None:
                    c, s = ch, sh
            if self.scale:
                sf = self.scale_factor
                s = s * np.clip(self.rng.random() * sf + 1, 1 - sf, 1 + sf)
            if self.rotate_prob and self.rng.random() < self.rotate_prob:
                rf = self.rotation_factor
                r = float(np.clip(self.rng.random() * rf, -2 * rf, 2 * rf))
            if self.flip_prob and self.rng.random() < self.flip_prob:
                img = img[:, ::-1, :]
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, img.shape[1], self.flip_pairs)
                c[0] = img.shape[1] - c[0] - 1

        trans = get_affine_transform(c, s, PIXEL_STD, r, self.image_size)
        img = cv2.warpAffine(img, trans.astype(np.float32),
                             self.image_size, flags=cv2.INTER_LINEAR)
        vis_mask = joints_vis[:, 0] > 0
        joints[vis_mask, :2] = affine_transform_batch(joints[vis_mask, :2],
                                                      trans)

        meta = {"imgId": rec["imgId"], "annId": rec["annId"],
                "center": c, "scale": s, "rotation": r,
                "joints": joints, "joints_visibility": joints_vis}
        if self.device_input:
            # raw batch: normalize + Gaussian render happen inside the
            # train step (render_batch_on_device); ship uint8 + coords
            return np.ascontiguousarray(img), None, None, meta

        target, weight = generate_gaussian_targets_np(
            joints, joints_vis, self.heatmap_size, self.image_size,
            self.heatmap_sigma, self.joints_weight,
            self.use_different_joints_weight)

        img = (img.astype(np.float32) / 255.0
               - np.asarray(IMAGENET_MEAN, np.float32)) \
            / np.asarray(IMAGENET_STD, np.float32)
        return img, target, weight, meta


_WORKER_DS = None


def _worker_init(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_get(seed_idx):
    seed, i = seed_idx
    _WORKER_DS.rng = random.Random(seed * 1_000_003 + i)
    return _WORKER_DS[i]


def _collate(items):
    if items[0][1] is None:  # device_input raw batches (uint8 + coords)
        return {
            "images_u8": np.stack([it[0] for it in items]),
            "joints": np.stack(
                [it[3]["joints"][:, :2] for it in items]).astype(np.float32),
            "joints_vis": np.stack(
                [it[3]["joints_visibility"] for it in items]
            ).astype(np.float32),
            "meta": [it[3] for it in items],
        }
    return {
        "images": np.stack([it[0] for it in items]),
        "targets": np.stack([it[1] for it in items]),
        "target_weights": np.stack([it[2] for it in items]),
        "meta": [it[3] for it in items],
    }


def batch_iterator(ds: CocoPoseDataset, batch_size: int,
                   shuffle: bool = True, drop_last: bool = True,
                   prefetch: int = 2, seed: int = 0, workers: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Assemble NHWC batches; the reference's DataLoader(num_workers,
    DistributedSampler) role.

    workers=0: a background producer THREAD overlaps augmentation with the
    device step (enough when cv2 releases the GIL).  workers>0: a spawn-based
    process pool maps ``ds[i]`` across workers (the reference's
    ``workers_per_gpu``) — use when per-sample augmentation is Python-bound.
    'spawn' (not fork) because the parent may hold an initialized CUDA context;
    standard spawn caveat applies: the main module must be importable
    (scripts with ``if __name__ == "__main__"``, not stdin/REPL one-liners).
    """
    order = list(range(len(ds)))
    if shuffle:
        random.Random(seed).shuffle(order)
    n_batches = (len(order) // batch_size if drop_last
                 else (len(order) + batch_size - 1) // batch_size)

    def make(bi):
        idxs = order[bi * batch_size:(bi + 1) * batch_size]
        return _collate([ds[i] for i in idxs])

    if workers > 0:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        used = order[:n_batches * batch_size] if drop_last else order
        # the dataset ships to each worker ONCE (initializer initargs), not
        # per chunk — imap then sends bare (seed, index) pairs.  Each sample
        # reseeds the worker's RNG from (epoch seed, index): deterministic,
        # distinct per sample AND per epoch (a pickled stateful RNG would
        # replay identical draws for every chunk and every epoch).
        with ctx.Pool(workers, initializer=_worker_init,
                      initargs=(ds,)) as pool:
            stream = pool.imap(_worker_get, ((seed, i) for i in used),
                               chunksize=8)
            buf = []
            for item in stream:
                buf.append(item)
                if len(buf) == batch_size:
                    yield _collate(buf)
                    buf = []
            if buf and not drop_last:
                yield _collate(buf)
        return

    if prefetch <= 0:
        for bi in range(n_batches):
            yield make(bi)
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    SENT = object()

    def worker():
        # a raising dataset must fail the consumer loudly, not strand it
        # on q.get() forever (failure-detection: the reference's
        # DataLoader re-raises worker errors too)
        try:
            for bi in range(n_batches):
                q.put(make(bi))
            q.put(SENT)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is SENT:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
