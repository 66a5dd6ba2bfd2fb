"""PyTorch port: the training data path and the host-side eval math against
the JAX package, bit for bit.

On a synthetic COCO-format set written once for the module (8 images of
240x320 noise, 2 people each, in a train and a val split), the port's
``CocoPoseDataset`` gives JAX's items (same seed, every augmentation on),
``batch_iterator`` JAX's order and collate, and a ``workers=2`` spawn pool
the in-process per-sample reseed.  The numpy copies (``ops/affine.py``,
``generate_gaussian_targets_np``, ``eval/metrics.py``, ``ops/oks.py``,
``eval/cocoeval.py``) equal JAX's on random inputs.  Every comparison here
is exact.
"""
import json

import numpy as np
import pytest

from easy_vitpose_tpu.eval import cocoeval as jcoco
from easy_vitpose_tpu.eval import metrics as jmetrics
from easy_vitpose_tpu.ops import affine as jaffine
from easy_vitpose_tpu.ops import heatmap as jheatmap
from easy_vitpose_tpu.ops import oks as joks
from easy_vitpose_tpu.train import dataset as jds
from easy_vitpose_tpu_torch.eval import cocoeval as pcoco
from easy_vitpose_tpu_torch.eval import metrics as pmetrics
from easy_vitpose_tpu_torch.ops import affine as paffine
from easy_vitpose_tpu_torch.ops import heatmap as pheatmap
from easy_vitpose_tpu_torch.ops import oks as poks
from easy_vitpose_tpu_torch.train import dataset as pds

cv2 = pytest.importorskip("cv2")


def write_coco(root, n_images=8, per_image=2, versions=("train2017", "val2017")):
    """A COCO-format keypoint set under ``root``: per split, noise images
    and people with 17 labeled joints inside them (the layout of
    tests/test_train_e2e.py).  Returns ``root`` as a string."""
    rng = np.random.default_rng(0)
    for ver in versions:
        (root / ver).mkdir()
        images, annotations = [], []
        for i in range(n_images):
            img = rng.integers(0, 255, (240, 320, 3), np.uint8)
            name = f"{i:012d}.jpg"
            cv2.imwrite(str(root / ver / name), img)
            images.append({"id": i, "file_name": name, "width": 320, "height": 240})
            for a in range(per_image):
                kp = np.zeros((17, 3))
                kp[:, 0] = rng.uniform(40, 280, 17)
                kp[:, 1] = rng.uniform(40, 200, 17)
                kp[:, 2] = 2
                x0, y0 = kp[:, 0].min() - 5, kp[:, 1].min() - 5
                bw, bh = kp[:, 0].max() - x0 + 5, kp[:, 1].max() - y0 + 5
                annotations.append({
                    "id": i * 10 + a, "image_id": i, "category_id": 1,
                    "keypoints": kp.ravel().tolist(), "num_keypoints": 17,
                    "bbox": [float(x0), float(y0), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0})
        (root / "annotations").mkdir(exist_ok=True)
        with open(root / "annotations" / f"person_keypoints_{ver}.json", "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return str(root)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco"))


def assert_items_equal(a, b):
    """Two ``(img, target, weight, meta)`` items (or collated batches)
    equal bit for bit, dtypes included."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_items_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_items_equal(x, y)
    elif a is None or isinstance(a, (int, float)):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "val", "device_input"])
def test_dataset_items_equal_jax(coco_dir, mode):
    """Every item, twice over (the augmentation draws run on): train mode
    with every augmentation on (half body, scale, rotation, flip), val mode,
    and the device-input items (uint8 crops and joints)."""
    kw = dict(is_train=mode != "val", seed=3, device_input=mode == "device_input",
              half_body_prob=1.0 if mode == "train" else 0.3)
    version = "val2017" if mode == "val" else "train2017"
    j = jds.CocoPoseDataset(coco_dir, version, **kw)
    p = pds.CocoPoseDataset(coco_dir, version, **kw)
    assert len(p) == len(j) == 16
    assert_items_equal(p.data, j.data)
    for _ in range(2):
        for i in range(len(p)):
            assert_items_equal(p[i], j[i])
    assert p.rng.random() == j.rng.random()


@pytest.mark.parametrize("device_input", [False, True])
def test_batch_iterator_order_and_collate_equal_jax(coco_dir, device_input):
    """Shuffled and drop-last batches through the prefetch thread, and the
    in-order tail batch: the same rows, keys and arrays as JAX's."""
    j = jds.CocoPoseDataset(coco_dir, "train2017", seed=5, device_input=device_input)
    p = pds.CocoPoseDataset(coco_dir, "train2017", seed=5, device_input=device_input)
    for kw in (dict(batch_size=6, shuffle=True, seed=7), dict(batch_size=6, shuffle=False,
                                                              drop_last=False, prefetch=0)):
        got, ref = list(pds.batch_iterator(p, **kw)), list(jds.batch_iterator(j, **kw))
        assert len(got) == len(ref) == (2 if kw["shuffle"] else 3)
        assert_items_equal(got, ref)


def test_spawn_workers_equal_in_process_reseed(coco_dir):
    """``workers=2``: a spawn pool whose workers reseed per sample from
    (epoch seed, index) gives, in order, the items of that reseed in this
    process and of JAX's ``_worker_get``."""
    p = pds.CocoPoseDataset(coco_dir, "train2017", seed=0)
    got = list(pds.batch_iterator(p, 4, shuffle=True, seed=11, workers=2))
    order = list(range(len(p)))
    import random
    random.Random(11).shuffle(order)
    pds._worker_init(pds.CocoPoseDataset(coco_dir, "train2017", seed=0))
    jds._worker_init(jds.CocoPoseDataset(coco_dir, "train2017", seed=0))
    items = [pds._worker_get((11, i)) for i in order]
    assert_items_equal(items, [jds._worker_get((11, i)) for i in order])
    assert_items_equal(got, [pds._collate(items[b:b + 4]) for b in range(0, 16, 4)])


def test_affine_equal_jax():
    """The affine helpers on random centers, scales, rotations, joints and
    flips; the UDP warp; the regression flip in both center modes."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        c = rng.uniform(0, 300, 2).astype(np.float32)
        s = rng.uniform(0.2, 3.0, 2).astype(np.float32)
        r = float(rng.uniform(-90, 90))
        shift = tuple(rng.uniform(-0.2, 0.2, 2))
        for inv in (False, True):
            a = paffine.get_affine_transform(c, s, 200, r, (192, 256), shift, inv)
            np.testing.assert_array_equal(
                a, jaffine.get_affine_transform(c, s, 200, r, (192, 256), shift, inv))
        pts = rng.uniform(-50, 350, (17, 2)).astype(np.float32)
        np.testing.assert_array_equal(paffine.affine_transform_batch(pts, a),
                                      jaffine.affine_transform_batch(pts, a))
        np.testing.assert_array_equal(paffine.affine_transform(pts[0], a),
                                      jaffine.affine_transform(pts[0], a))
        vis = (rng.uniform(size=(17, 2)) > 0.3).astype(np.float32)
        pairs = [[1, 2], [3, 4], [5, 6]]
        for x, y in zip(paffine.fliplr_joints(pts, vis, 320, pairs),
                        jaffine.fliplr_joints(pts, vis, 320, pairs)):
            np.testing.assert_array_equal(x, y)
        m = paffine.get_warp_matrix(r, (192.0, 256.0), (191.0, 255.0), (300.0, 400.0))
        np.testing.assert_array_equal(
            m, jaffine.get_warp_matrix(r, (192.0, 256.0), (191.0, 255.0), (300.0, 400.0)))
        np.testing.assert_array_equal(paffine.warp_affine_joints(pts, m),
                                      jaffine.warp_affine_joints(pts, m))
    reg = rng.uniform(0, 1, (3, 17, 2)).astype(np.float32)
    for mode in ("static", "root"):
        np.testing.assert_array_equal(
            paffine.fliplr_regression(reg, [[1, 2], [5, 6]], center_mode=mode),
            np.asarray(jaffine.fliplr_regression(reg, [[1, 2], [5, 6]], center_mode=mode)))


def test_numpy_targets_equal_jax():
    """The host renderer, with joints off the map, negative and on the
    border, weights per joint: targets and weights bit for bit."""
    rng = np.random.default_rng(1)
    for sigma in (2.0, 3.0):
        joints = rng.uniform(-40, 240, (17, 2)).astype(np.float32)
        joints[:3] = [[-30.0, 10.0], [-2.3, -2.6], [191.5, 255.5]]
        vis = (rng.uniform(size=(17, 2)) > 0.2).astype(np.float32)
        jw = rng.uniform(0.5, 1.5, (17, 1)).astype(np.float32)
        for diff in (False, True):
            got = pheatmap.generate_gaussian_targets_np(joints, vis, (48, 64), (192, 256),
                                                         sigma, jw, diff)
            ref = jheatmap.generate_gaussian_targets(joints, vis, (48, 64), (192, 256),
                                                     sigma, jw, diff)
            for x, y in zip(got, ref):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_metrics_equal_jax():
    """PCK from heatmaps (argmax both sides), AUC, NME, EPE and the
    multi-label accuracy on random inputs with masked joints."""
    rng = np.random.default_rng(2)
    out = rng.uniform(-0.1, 1.0, (4, 17, 64, 48)).astype(np.float32)
    tgt = rng.uniform(-0.1, 1.0, (4, 17, 64, 48)).astype(np.float32)
    mask = rng.uniform(size=(4, 17)) > 0.2
    got, ref = pmetrics.pose_pck_accuracy(out, tgt, mask), jmetrics.pose_pck_accuracy(out, tgt, mask)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    pred = rng.uniform(0, 50, (4, 17, 2)).astype(np.float32)
    gt = pred + rng.normal(0, 3, pred.shape).astype(np.float32)
    norm = rng.uniform(10, 40, (4, 2)).astype(np.float32)
    assert pmetrics.keypoint_auc(pred, gt, mask, 30.0) == jmetrics.keypoint_auc(pred, gt, mask, 30.0)
    assert pmetrics.keypoint_nme(pred, gt, mask, norm) == jmetrics.keypoint_nme(pred, gt, mask, norm)
    assert pmetrics.keypoint_epe(pred, gt, mask) == jmetrics.keypoint_epe(pred, gt, mask)
    lp, lg = rng.uniform(size=(6, 3)), rng.uniform(size=(6, 3))
    lm = rng.uniform(size=(6, 3)) > 0.2
    assert (pmetrics.multilabel_classification_accuracy(lp, lg, lm)
            == jmetrics.multilabel_classification_accuracy(lp, lg, lm))


def random_poses(rng, n):
    kp = np.concatenate([rng.uniform(0, 200, (n, 17, 2)), rng.uniform(0, 1, (n, 17, 1))], -1)
    return [{"keypoints": kp[i], "score": float(rng.uniform()), "area": float(rng.uniform(500, 9000))}
            for i in range(n)]


def test_oks_equal_jax():
    """OKS IoU with and without the visibility gate, greedy and soft OKS
    NMS, and the box NMS, on random poses that overlap."""
    rng = np.random.default_rng(3)
    db = random_poses(rng, 12)
    for i in range(6, 12):          # near-copies, so NMS suppresses
        db[i]["keypoints"] = db[i - 6]["keypoints"] + rng.normal(0, 2, (17, 3))
    kpts = np.array([d["keypoints"].ravel() for d in db])
    areas = np.array([d["area"] for d in db])
    for vis in (None, 0.3):
        np.testing.assert_array_equal(poks.oks_iou(kpts[0], kpts[1:], areas[0], areas[1:], vis_thr=vis),
                                      joks.oks_iou(kpts[0], kpts[1:], areas[0], areas[1:], vis_thr=vis))
        np.testing.assert_array_equal(poks.oks_nms(db, 0.5, vis_thr=vis), joks.oks_nms(db, 0.5, vis_thr=vis))
        np.testing.assert_array_equal(poks.soft_oks_nms(db, 0.3, vis_thr=vis),
                                      joks.soft_oks_nms(db, 0.3, vis_thr=vis))
    boxes = np.concatenate([rng.uniform(0, 100, (20, 2)), rng.uniform(100, 200, (20, 2)),
                            rng.uniform(size=(20, 1))], 1)
    assert poks.bbox_nms(boxes, 0.4) == joks.bbox_nms(boxes, 0.4)
    np.testing.assert_array_equal(poks.DEFAULT_SIGMAS, joks.DEFAULT_SIGMAS)


def test_cocoeval_equal_jax(coco_dir, tmp_path):
    """AP and AR on the val split's annotations against detections near
    them, some far off, some extra (every stat of ``accumulate``, the OKS
    matrix and the results-file entry point)."""
    gt_path = f"{coco_dir}/annotations/person_keypoints_val2017.json"
    with open(gt_path) as f:
        gt = json.load(f)
    rng = np.random.default_rng(4)
    res = []
    for ann in gt["annotations"]:
        kp = np.asarray(ann["keypoints"], np.float64).reshape(17, 3)
        kp[:, :2] += rng.normal(0, rng.choice([1.0, 8.0, 40.0]), (17, 2))
        kp[:, 2] = rng.uniform(0.1, 1.0, 17)
        res.append({"image_id": ann["image_id"], "category_id": 1,
                    "keypoints": kp.ravel().tolist(), "score": float(rng.uniform())})
    res += [{**r, "score": r["score"] * 0.5} for r in res[:3]]
    got, ref = pcoco.CocoKeypointEval(gt, res).accumulate(), jcoco.CocoKeypointEval(gt, res).accumulate()
    assert got == ref and 0.0 < got["AP"] < 1.0
    gk = np.asarray(gt["annotations"][0]["keypoints"], np.float64).reshape(17, 3)
    dk = np.stack([np.asarray(r["keypoints"]).reshape(17, 3) for r in res[:5]])
    np.testing.assert_array_equal(pcoco.compute_oks(gk, 5000.0, dk), jcoco.compute_oks(gk, 5000.0, dk))
    path = tmp_path / "results.json"
    path.write_text(json.dumps(res))
    assert pcoco.evaluate_results_file(gt_path, str(path)) == ref
