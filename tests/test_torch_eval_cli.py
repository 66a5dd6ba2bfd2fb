"""PyTorch port: cli/eval_coco.py against the JAX package's, on the CPU.

Both CLIs run on the same synthetic val set (images written with cv2 as
tests/test_eval_cli.py writes them; two people an image, one at a box near
the border) with the tiny golden ViTPose (``model_cfg=``; the JAX image
lane builds its config itself, so its ``get_model_config`` is patched to
the same tiny config).  The annotations' keypoints are JAX's own fp32
predictions moved by a few px, so the AP summary is far from 0 and moves
with the keypoints.

Tolerances.  Keypoints: fp32 as tests/test_torch_inference.py (scores
within 1e-5 before the CLIs round to 0.01, so within 0.01 + 1e-5 after;
coordinates within 0.5 px except at most 2 of a person's 17 keypoints, the
median within 0.01 px); int8 as tests/test_torch_shipping_dtypes.py
(scores within 0.01 + the rounding, coordinates a median under 1 px, at
most 8 of 17 over 2 px: the port's int8 block and JAX's ``xla_q8`` block
round differently).  AP: every summary stat within ``AP_TOL`` (at int8
the stats at one OKS threshold are coarse over 8 instances, the averaged
AP and AR are held tighter).
"""
import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import easy_vitpose_tpu.pipeline.inference as jinference  # noqa: E402
from easy_vitpose_tpu.cli.eval_coco import main as jmain  # noqa: E402
from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict  # noqa: E402
from easy_vitpose_tpu.utils.checkpoint import save_params  # noqa: E402
from easy_vitpose_tpu_torch.cli.eval_coco import main as pmain  # noqa: E402
from tests.test_model_parity import CASES as JCASES  # noqa: E402
from tests.test_model_parity import load_case  # noqa: E402
from tests.test_torch_model import CASES as PCASES  # noqa: E402

torch.set_num_threads(1)
# AP summary gaps over these 8 instances (measured: fp32 0 and 0.0198, one
# instance's two flipped keypoints; int8: AP 0.053, AR 0.05, AP .75 0.362 and
# AR .75 0.25, where one instance of 8 crossing OKS 0.75 moves the stat)
AP_TOL = {"fp32": 0.03, "int8": 0.1, "int8_one_threshold": 0.4}
N_IMAGES = 4


def _annotations(rng, preds=None):
    anns = []
    for i in range(N_IMAGES):
        for j, (x0, y0, bw, bh) in enumerate(((30, 20, 120, 180), (170, 60, 140, 175))):
            aid = 2 * i + j + 1
            if preds is None:
                kp = np.zeros((17, 3))
                kp[:, 0] = rng.uniform(x0, x0 + bw, 17)
                kp[:, 1] = rng.uniform(y0, y0 + bh, 17)
            else:
                kp = preds[aid].copy()
                kp[:, :2] += rng.normal(0, 3.0, (17, 2))
            kp[:, 2] = 2
            anns.append({"id": aid, "image_id": i, "category_id": 1,
                         "keypoints": kp.ravel().tolist(), "num_keypoints": 17,
                         "bbox": [float(x0), float(y0), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0})
    return anns


@pytest.fixture(scope="module")
def val(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    sd, _, _ = load_case("tiny")
    ckpt = str(d / "vitpose-s-coco.npz")
    save_params(ckpt, convert_vitpose_state_dict(sd, JCASES["tiny"]))
    imgdir = d / "val"
    imgdir.mkdir()
    rng = np.random.default_rng(0)
    images = []
    for i in range(N_IMAGES):
        name = f"{i:012d}.jpg"
        cv2.imwrite(str(imgdir / name), rng.integers(0, 255, (240, 320, 3), np.uint8))
        images.append({"id": i, "file_name": name, "width": 320, "height": 240})
    ann = str(d / "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": _annotations(rng)}, f)
    # the annotations' keypoints: JAX's predictions moved by a few px
    out = str(d / "seed.json")
    jmain(["--ann", ann, "--imgdir", str(imgdir), "--model", ckpt, "--model-name", "s",
           "--gt-crops-batched", "4", "--dtype", "fp32", "--out", out],
          model_cfg=JCASES["tiny"])
    preds = {r["ann_id"]: np.asarray(r["keypoints"]).reshape(17, 3) for r in json.load(open(out))}
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": _annotations(rng, preds)}, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinference, "get_model_config", lambda dataset, size: JCASES["tiny"])
        yield {"dir": d, "ann": ann, "imgdir": str(imgdir), "ckpt": ckpt}


def run_both(val, *argv, port_args=()):
    out = {}
    for name, main, cfg in (("jax", jmain, JCASES["tiny"]), ("port", pmain, PCASES["tiny"])):
        path = str(val["dir"] / f"{name}.json")
        extra = ["--device", "cpu", *port_args] if name == "port" else []
        stats = main(["--ann", val["ann"], "--imgdir", val["imgdir"], "--model", val["ckpt"],
                      "--model-name", "s", "--out", path, *argv, *extra], model_cfg=cfg)
        out[name] = (stats, json.load(open(path)))
    return out


def keypoints(results):
    return np.stack([np.asarray(r["keypoints"]).reshape(-1, 3) for r in results])


def check(out, int8=False, seeded=False):
    """Both CLIs' results and AP summaries; ``seeded``: the run whose
    predictions the annotations were made from, so its AP is far from 0.
    Soft OKS-NMS orders an image's results by their new scores, which the
    int8 gap can swap: results are matched by (image, annotation)."""
    (js, jr), (ps, pr) = out["jax"], out["port"]
    if "ann_id" in jr[0]:
        jr, pr = (sorted(r, key=lambda x: (x["image_id"], x["ann_id"])) for r in (jr, pr))
    assert [r["image_id"] for r in pr] == [r["image_id"] for r in jr]
    assert [r.get("ann_id") for r in pr] == [r.get("ann_id") for r in jr]
    a, b = keypoints(jr), keypoints(pr)
    d = np.abs(a[..., :2] - b[..., :2]).max(-1)
    if int8:
        assert np.abs(a[..., 2] - b[..., 2]).max() < 0.01 + 0.0051
        assert np.median(d) < 1.0 and (d >= 2.0).sum(-1).max() <= 8
    else:
        assert np.abs(a[..., 2] - b[..., 2]).max() < 0.01 + 1e-5
        assert (d >= 0.5 + 0.01).sum(-1).max() <= 2 and np.median(d) < 0.01 + 1e-5
    assert js.keys() == ps.keys() and (js["AP"] > 0.2 or not seeded)
    for k in js:
        tol = AP_TOL["int8_one_threshold" if int8 and k not in ("AP", "AR") else
                     "int8" if int8 else "fp32"]
        assert abs(js[k] - ps[k]) <= tol, (k, js[k], ps[k])


def test_gt_bbox_lane_matches_jax(val):
    out = run_both(val, "--use-gt-bbox", "--dtype", "fp32")
    assert len(out["port"][1]) == 2 * N_IMAGES
    check(out)


def test_gt_crops_fp32_hard_nms_per_keypoint_matches_jax(val, capsys):
    out = run_both(val, "--gt-crops-batched", "3", "--dtype", "fp32", "--oks-nms", "hard",
                   "--per-keypoint")
    printed = capsys.readouterr().out
    assert printed.count("per-keypoint PCK@0.05") == 2 and "left_ankle" in printed
    assert printed.count("OKS hard-NMS") == 2
    check(out, seeded=True)


def test_gt_crops_int8_soft_nms_matches_jax(val):
    out = run_both(val, "--gt-crops-batched", "4", "--dtype", "int8", "--oks-nms", "soft")
    check(out, int8=True, seeded=True)


def test_gt_crops_flip_test_matches_jax(val):
    out = run_both(val, "--gt-crops-batched", "8", "--dtype", "fp32", "--flip-test")
    assert len(out["port"][1]) == 2 * N_IMAGES
    check(out)


def test_gt_crops_data_parallel_matches_one_device_and_jax(val):
    """``--gt-crops-batched 8`` over a two-entry CPU mesh (``--devices cpu
    cpu``: each batch's rows in two blocks, a replica and the decode per
    entry, gathered in order) gives the one-device results bit for bit,
    and holds to JAX's data-parallel branch (8 virtual devices divide the
    batch) at the fp32 bounds."""
    out = run_both(val, "--gt-crops-batched", "8", "--dtype", "fp32",
                   port_args=("--devices", "cpu", "cpu"))
    one = str(val["dir"] / "one.json")
    pmain(["--ann", val["ann"], "--imgdir", val["imgdir"], "--model", val["ckpt"],
           "--model-name", "s", "--gt-crops-batched", "8", "--dtype", "fp32", "--device", "cpu",
           "--out", one], model_cfg=PCASES["tiny"])
    assert out["port"][1] == json.load(open(one))
    check(out)


def test_task_on_a_single_task_checkpoint_exits(val):
    with pytest.raises(SystemExit):
        pmain(["--ann", val["ann"], "--imgdir", val["imgdir"], "--model", val["ckpt"],
               "--model-name", "s", "--gt-crops-batched", "2", "--task", "mpii",
               "--device", "cpu", "--out", str(val["dir"] / "x.json")],
              model_cfg=PCASES["tiny"])
    if not torch.cuda.is_available():            # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            pmain(["--ann", val["ann"], "--imgdir", val["imgdir"], "--model", val["ckpt"],
                   "--model-name", "s", "--gt-crops-batched", "2",
                   "--out", str(val["dir"] / "x.json")], model_cfg=PCASES["tiny"])
