"""COCO val evaluation CLI (reference evaluation_on_coco.py:31-91 workflow):
run the model over val images, write results.json, score with the
built-in OKS AP evaluator (pycocotools-free).

Port of ``easy_vitpose_tpu/cli/eval_coco.py`` with all of its flags, on
CUDA unless ``--device cpu`` is given:

* the image lane: ``VitInference`` per image (``--use-gt-bbox``, the
  detector, ``--flip-test``, ``--task``), images read with cv2 as there;
* ``--gt-crops-batched B``: the dataset's affine crops (``train/dataset.py``,
  cv2) through the forward in fixed batches of B (a tail batch padded by
  repeating its last crop, so every batch has one shape), then the UDP
  decode on the device (``ops/decode.py::keypoints_from_heatmaps_udp``, the
  plain decode as JAX's eval uses its XLA decode);
* scoring: ``--oks-nms`` hard or soft, ``--per-keypoint``, COCO AP.

``--plain`` runs every kernel's plain version (the comparison the card's
checks make).  ``main(argv, model_cfg=)`` hands a custom config to both
lanes (JAX's image lane builds its own from ``--model-name``).

Data-parallel gt crops (JAX's branch over the local mesh): where the local
``batch`` mesh (every local CUDA device, or ``--devices``) has more than
one entry and divides B, each batch is split over its devices, each with a
replica of the model running its rows' forward (K1 or K2 blocks on the
card) and decode; the host gathers the rows in order.

Usage:
  python -m easy_vitpose_tpu_torch.cli.eval_coco --ann ann.json --imgdir val2017 \\
      --model vitpose-b-coco.npz --model-name b --yolo yolov8n.npz
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..eval.cocoeval import CocoKeypointEval
from ..pipeline.inference import VitInference
from ..utils.io import NumpyEncoder

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def main(argv=None, model_cfg=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann", required=True, help="COCO keypoint ann json")
    p.add_argument("--imgdir", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--model-name", required=True, choices=["s", "b", "l", "h"])
    p.add_argument("--dataset", default=None,
                   help="default: the --task name, else inferred from the "
                        "checkpoint filename")
    p.add_argument("--yolo", default=None)
    p.add_argument("--yolo-size", type=int, default=640)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32", "int8"])
    p.add_argument("--out", default="results.json")
    p.add_argument("--limit", type=int, default=0, help="max images (debug)")
    p.add_argument("--use-gt-bbox", action="store_true",
                   help="evaluate with ground-truth boxes (no detector)")
    p.add_argument("--gt-crops-batched", type=int, default=0, metavar="B",
                   help="fast gt-crop path: dataset-style affine crops in "
                        "fixed batches of B through the forward (no "
                        "detector, no per-image pipeline) — the cheap way "
                        "to run the AP parity gate; supports bf16/fp32/int8")
    p.add_argument("--oks-nms", choices=["none", "hard", "soft"],
                   default="none",
                   help="per-image OKS NMS over predictions before scoring "
                        "(the reference dataset writer's nms/soft_nms, "
                        "datasets/COCO.py:441-496; thresholds from "
                        "configs data_cfg: oks_thr=0.9, vis_thr=0.2)")
    p.add_argument("--oks-thr", type=float, default=0.9)
    p.add_argument("--task", default=None,
                   help="task head for multi-task (ViTPose+) checkpoints")
    p.add_argument("--per-keypoint", action="store_true",
                   help="with --gt-crops-batched: also print a per-keypoint "
                        "PCK@0.05 table (bbox-normalized, matched 1:1 to "
                        "each gt instance) with skeleton joint names")
    p.add_argument("--flip-test", action="store_true",
                   help="flip-test averaging (mmpose eval protocol: also "
                        "forward the mirrored crop, un-flip, average; the "
                        "reference declares flip_test in its configs but "
                        "never wires it)")
    p.add_argument("--device", default=None,
                   help="torch device; default CUDA ('cpu' runs the kernels' plain versions)")
    p.add_argument("--plain", action="store_true",
                   help="run every kernel's plain version on the device (for checks)")
    p.add_argument("--devices", nargs="+", default=None,
                   help="with --gt-crops-batched: the local mesh's entries (default: every "
                        "local CUDA device; the --device alone where it is the CPU)")
    args = p.parse_args(argv)

    with open(args.ann) as f:
        gt = json.load(f)
    images = {im["id"]: im for im in gt["images"]}
    img_ids = sorted({a["image_id"] for a in gt["annotations"]
                      if a.get("num_keypoints", 0) > 0})
    if args.limit:
        img_ids = img_ids[:args.limit]

    gt_boxes = {}
    if args.use_gt_bbox:
        for a in gt["annotations"]:
            if a.get("num_keypoints", 0) == 0 or a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            gt_boxes.setdefault(a["image_id"], []).append([x, y, x + w, y + h, 1.0])

    if args.gt_crops_batched:
        results = _gt_crops_batched(args, model_cfg=model_cfg)
        return _score(args, gt, results)

    if cv2 is None:
        raise RuntimeError("the image lane reads images with cv2, which is not installed; "
                           "--gt-crops-batched needs it too (train/dataset.py)")
    dataset = args.dataset
    if dataset is None and args.task is None:
        dataset = _dataset_from_name(args.model)
    model = VitInference(args.model, yolo=args.yolo,
                         model_name=args.model_name, dataset=dataset,
                         yolo_size=args.yolo_size, is_video=False,
                         dtype=args.dtype, task=args.task,
                         flip_test=args.flip_test, model_cfg=model_cfg,
                         device=args.device, plain=args.plain)

    results = []
    t0 = time.perf_counter()
    for n, img_id in enumerate(img_ids):
        path = os.path.join(args.imgdir, images[img_id]["file_name"])
        img = cv2.imread(path)
        if img is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        bboxes = (np.asarray(gt_boxes.get(img_id, []), np.float32)
                  if args.use_gt_bbox else None)
        if bboxes is not None and len(bboxes) == 0:
            continue
        kpts = model.inference(img, bboxes=bboxes)
        for pid, k in kpts.items():
            # k rows are (y, x, score); COCO wants flat [x, y, v] * K.
            # Keep the per-keypoint confidence in the third slot (like the
            # reference dataset writer, datasets/COCO.py:481) — COCOeval
            # ignores predicted v, but the --oks-nms path below gates
            # keypoints on it via vis_thr, so zeros would make OKS-NMS a
            # silent no-op.
            flat = np.stack([k[:, 1], k[:, 0], k[:, 2]], -1).ravel()
            results.append({
                "image_id": int(img_id), "category_id": 1,
                "keypoints": [round(float(v), 2) for v in flat],
                "score": float(model._scores_bbox.get(pid, float(k[:, 2].mean()))),
            })
        if (n + 1) % 100 == 0:
            rate = (n + 1) / (time.perf_counter() - t0)
            print(f"  {n + 1}/{len(img_ids)} images ({rate:.1f} img/s)")

    return _score(args, gt, results)


def _dataset_from_name(path: str) -> str:
    """The dataset named in a checkpoint's file name, or "coco" where the
    name holds none (``model-final.npz`` would 'infer' the junk token
    'final')."""
    from ..configs import NUM_KEYPOINTS, infer_dataset_by_path
    try:
        dataset = infer_dataset_by_path(path)
    except ValueError:
        dataset = None
    return dataset if dataset in NUM_KEYPOINTS else "coco"


def forward_heatmaps(model, x, flip_pairs=None, plain: bool = False):
    """(B, 256, 192, 3) crops on the model's device -> (B, K, 64, 48)
    float32 heatmaps, averaged with the un-flipped heatmaps of the mirrored
    crops under ``flip_pairs``."""
    from ..models.vitpose import vitpose_forward
    from ..ops.affine import flip_back_heatmaps
    h = vitpose_forward(model, x, plain=plain).float()
    if flip_pairs is not None:
        hf = vitpose_forward(model, x.flip(2), plain=plain).float()
        h = 0.5 * (h + flip_back_heatmaps(hf, flip_pairs))
    return h


def _gt_crops_batched(args, model_cfg=None):
    """Batched gt-crop evaluation: dataset-style affine crops -> fixed-batch
    forward -> UDP decode -> COCO results.

    Isolates model quality from the detector and runs at the forward's
    throughput, so the "AP within 0.3" parity gate
    (reference evaluation_on_coco.py:76-87) is one cheap command once real
    checkpoints are reachable; int8 gives the quantization AP delta the
    same way."""
    import torch

    from ..configs import NUM_KEYPOINTS, get_model_config
    from ..convert.vitpose_plus import is_plus_params
    from ..kernels import resolve_device
    from ..models.vitpose import compute_dtype, serving_copy, serving_replica
    from ..ops.decode import keypoints_from_heatmaps_udp
    from ..pipeline.inference import SERVING, model_from_params
    from ..train.dataset import PIXEL_STD, CocoPoseDataset, batch_iterator
    from ..utils.checkpoint import load_params

    dataset = args.dataset
    if dataset is None and args.task is not None:
        dataset = args.task  # a multi-task checkpoint's task IS its dataset
    if dataset is None:
        dataset = _dataset_from_name(args.model)
    args.dataset = dataset  # resolved name (for the per-keypoint report)
    K = NUM_KEYPOINTS[dataset]
    cfgm = model_cfg or get_model_config(dataset, args.model_name)
    device = resolve_device(args.device)
    params = load_params(args.model)
    # a multi-task (ViTPose+) checkpoint: the task's expert + head spliced
    # into a single-task tree, as VitInference does
    if args.task is not None and not is_plus_params(params):
        raise SystemExit("--task requires a multi-task (ViTPose+) "
                         "checkpoint from 'cli/convert plus'")
    net = model_from_params(params, cfgm, task=args.task, dataset=dataset)
    model = serving_replica(serving_copy(net, SERVING[args.dtype]), device)
    in_dtype = compute_dtype(model)
    B = args.gt_crops_batched
    # data-parallel over the local mesh where it divides the batch: a
    # replica per device, each batch's rows in per-device blocks
    shards = [(device, model)]
    if args.devices is not None or device.type == "cuda":
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(axis="batch", devices=args.devices)
        if mesh.size > 1 and B % mesh.size == 0:
            replicas = {device: model}
            for d in mesh.devices:
                if d not in replicas:
                    replicas[d] = serving_replica(model, d)
            shards = [(d, replicas[d]) for d in mesh.devices]
    fp = None
    if args.flip_test:
        from ..skeletons import flip_pairs as _flip_pairs
        fp = tuple(tuple(int(v) for v in pr) for pr in _flip_pairs(dataset))

    ds = CocoPoseDataset(
        root_path=os.path.dirname(args.imgdir.rstrip("/")) or ".",
        data_version=os.path.basename(args.imgdir.rstrip("/")),
        ann_file=args.ann, is_train=False, num_joints=K)
    if args.limit:
        ds.data = ds.data[:args.limit]  # --limit counts gt instances here
    results = []
    t0 = time.perf_counter()
    done = 0
    per = B // len(shards)
    for b in batch_iterator(ds, B, shuffle=False, drop_last=False, prefetch=2):
        n = len(b["images"])
        imgs = b["images"]
        metas = b["meta"]
        centers = np.stack([m["center"] for m in metas]).astype(np.float32)
        scales = (np.stack([m["scale"] for m in metas]) * PIXEL_STD).astype(np.float32)
        if n < B:  # keep the forward's shape fixed
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], B - n, 0)])
            centers = np.concatenate([centers, np.repeat(centers[-1:], B - n, 0)])
            scales = np.concatenate([scales, np.repeat(scales[-1:], B - n, 0)])
        outs = []
        for j, (dev, rep) in enumerate(shards):
            rows = slice(j * per, (j + 1) * per)
            x = torch.from_numpy(np.ascontiguousarray(imgs[rows])).to(dev).to(in_dtype)
            with torch.no_grad():
                heat = forward_heatmaps(rep, x, fp, args.plain)
                outs.append(keypoints_from_heatmaps_udp(
                    heat, torch.from_numpy(centers[rows]).to(dev),
                    torch.from_numpy(scales[rows]).to(dev)))
        preds = np.concatenate([p_.cpu().numpy() for p_, _ in outs])[:n]
        maxv = np.concatenate([m_.cpu().numpy() for _, m_ in outs])[:n]
        for i, m in enumerate(metas):
            flat = np.concatenate([preds[i], maxv[i]], -1).ravel()
            results.append({
                "image_id": int(m["imgId"]), "category_id": 1,
                "keypoints": [round(float(v), 2) for v in flat],
                "score": float(maxv[i].mean()),
                "ann_id": int(m["annId"])})  # extra key; COCOeval ignores
        done += n
        if done % (20 * B) < B:
            rate = done / (time.perf_counter() - t0)
            print(f"  {done}/{len(ds)} crops ({rate:.1f} crop/s)")
    print(f"gt-crops-batched: {len(results)} detections "
          f"({len(ds) / (time.perf_counter() - t0):.1f} crop/s)")
    return results


def _per_keypoint_report(args, gt, results):
    """Per-keypoint PCK@0.05 over gt-matched instances (mmpose-style
    breakdown the reference never reports); distances normalized by each
    instance's gt bbox (w, h)."""
    from ..eval.metrics import keypoint_pck_accuracy
    anns = {a.get("id", -1): a for a in gt.get("annotations", [])}
    pred_list, gt_list, mask_list, norm_list = [], [], [], []
    for r in results:
        a = anns.get(r.get("ann_id"))
        if a is None:
            continue
        pk = np.asarray(r["keypoints"], np.float32).reshape(-1, 3)
        gk = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        if len(pk) != len(gk):
            continue
        pred_list.append(pk[:, :2])
        gt_list.append(gk[:, :2])
        mask_list.append(gk[:, 2] > 0)
        norm_list.append(np.asarray(a["bbox"][2:4], np.float32))
    if not pred_list:
        return
    acc, avg, cnt = keypoint_pck_accuracy(
        np.stack(pred_list), np.stack(gt_list), np.stack(mask_list),
        0.05, np.stack(norm_list))
    from ..skeletons import keypoint_names
    names = None
    if args.dataset:
        try:
            names = keypoint_names(args.dataset)
        except KeyError:
            names = None
        if names is not None and len(names) != len(acc):
            names = None
    print(f"per-keypoint PCK@0.05 (bbox-normalized, "
          f"{len(pred_list)} instances, {cnt} keypoint types):")
    for k, a in enumerate(acc):
        label = names[k] if names else f"kpt_{k}"
        val = "   n/a" if a < 0 else f"{a:6.3f}"
        print(f"  {label:24s} {val}")
    print(f"  {'mean':24s} {avg:6.3f}")


def _score(args, gt, results):
    """Optional OKS-NMS, results file, and AP summary (shared tail)."""
    if getattr(args, "per_keypoint", False):
        _per_keypoint_report(args, gt, results)
    if args.oks_nms != "none" and results:
        from collections import defaultdict
        from ..ops.oks import oks_nms, soft_oks_nms
        by_img = defaultdict(list)
        for r in results:
            by_img[r["image_id"]].append(r)
        kept = []
        for img_id, rs in by_img.items():
            db = []
            for r in rs:
                kp = np.asarray(r["keypoints"], np.float64).reshape(-1, 3)
                w = kp[:, 0].max() - kp[:, 0].min()
                h = kp[:, 1].max() - kp[:, 1].min()
                db.append({"keypoints": kp, "score": r["score"],
                           "area": max(w * h, 1.0)})
            fn = soft_oks_nms if args.oks_nms == "soft" else oks_nms
            keep = fn(db, args.oks_thr, vis_thr=0.2)
            kept.extend(rs[int(i)] for i in np.atleast_1d(keep))
        print(f"OKS {args.oks_nms}-NMS: {len(results)} -> {len(kept)} dets")
        results = kept

    with open(args.out, "w") as f:
        json.dump(results, f, cls=NumpyEncoder)
    print(f"wrote {args.out} ({len(results)} detections)")

    stats = CocoKeypointEval(gt, results).summarize()
    return stats


if __name__ == "__main__":
    main()
