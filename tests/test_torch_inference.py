"""PyTorch port: VitInference (image and video mode), its host tier and
cli/infer.py against the JAX package, on the CPU.

The scenarios are those of tests/test_vitinference.py,
tests/test_pipeline_semantics.py and tests/test_fused_detect.py, at fp32,
with the tiny golden ViTPose (tests/golden/model_tiny.npz) and a random
YOLOv8n at imgsz 160 (the port's ``init_yolo_params``, saved in the JAX
package's format).  On the CPU every kernel's plain version runs.

Tolerances: detections as tests/test_torch_detect.py (scores 5e-5, boxes
5e-3 input px); keypoints as tests/test_torch_pose_step.py: scores within
1e-5 (the same crops and heatmaps), and coordinates within 0.5 px except
at most 2 of a person's 17 keypoints (a random-weight model's flat heatmaps
may flip a tied argmax peak; across frames of one scene the same crop, and
so the same flip, repeats), with the median within 0.01 px.  Where the
detector decides what is compared, the scene's margins are asserted
against the measured port-vs-JAX noise (``detection_margins``).
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu import VitInference as JVI
from easy_vitpose_tpu.convert.vitpose_torch import (convert_vitpose_state_dict,
                                                     save_torch_checkpoint)
from easy_vitpose_tpu.convert.yolo_torch import save_yolo_npz
from easy_vitpose_tpu.detect import yolo as J
from easy_vitpose_tpu.utils.checkpoint import save_params
from easy_vitpose_tpu_torch.detect import yolo as P
from easy_vitpose_tpu_torch.pipeline.inference import VitInference as PVI
from tests.test_model_parity import CASES as JCASES
from tests.test_model_parity import load_case
from tests.test_torch_detect import assert_clear, detection_margins
from tests.test_torch_model import CASES as PCASES

torch.set_num_threads(1)
IMGSZ = 160


def frame_of(seed=0, shift=0, h=240, w=320):
    """tests/test_fused_detect.py's synthetic frame, moved right by
    ``shift`` px (a scene in motion)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([np.sin(xx / (11 + seed)), np.cos(yy / (13 + seed)),
                  np.sin((xx + yy) / (17 + seed))], -1)
    f = ((f - f.min()) / (np.ptp(f) + 1e-9) * 255).astype(np.uint8)
    return np.roll(f, shift, axis=1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny golden ViTPose as .npz and .pth, and a random YOLOv8n .npz."""
    d = tmp_path_factory.mktemp("ck")
    sd, _, _ = load_case("tiny")
    params = convert_vitpose_state_dict(sd, JCASES["tiny"])
    npz = str(d / "vitpose-s-coco.npz")
    save_params(npz, params)
    pth = str(d / "vitpose-s-coco.pth")
    save_torch_checkpoint(params, JCASES["tiny"], pth)
    yparams = P.init_yolo_params(0, P.YoloSpec("n"), frame_of(0), IMGSZ, cls_gain=0.75)
    yolo = str(d / "yolov8n.npz")
    save_yolo_npz(yolo, yparams, "n", 80)
    return {"npz": npz, "pth": pth, "yolo": yolo, "yparams": yparams}


def pair(ckpt, yolo=None, **kw):
    kw.setdefault("max_people", 8)
    j = JVI(ckpt, yolo=yolo, model_name="s", model_cfg=JCASES["tiny"], yolo_size=IMGSZ, **kw)
    p = PVI(ckpt, yolo=yolo, model_name="s", model_cfg=PCASES["tiny"], yolo_size=IMGSZ,
            device="cpu", **kw)
    return j, p


class Keypoints:
    """Collects both packages' keypoints frame by frame and checks the
    pose step's bounds over all of them."""

    def __init__(self):
        self.a, self.b = [], []

    def add(self, a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and np.isfinite(b[k]).all()
            self.a.append(a[k])
            self.b.append(b[k])

    def check(self, min_people=1):
        assert len(self.a) >= min_people
        a, b = np.stack(self.a), np.stack(self.b)
        assert np.abs(a[..., 2] - b[..., 2]).max() < 1e-5
        d = np.abs(a[..., :2] - b[..., :2]).max(-1)
        assert (d >= 0.5).sum(-1).max() <= 2, (d >= 0.5).sum(-1)
        assert np.median(d) < 0.01


def assert_scene_clear(files, frame, rect, conf_t=0.25):
    """The detector's margins on ``frame`` exceed twice the measured
    port-vs-JAX noise, for the gates the pipeline uses (the NMS at
    ``conf_t``, the 0.35 pose gate) and the crop's rounding."""
    spec = P.YoloSpec("n")
    geom = J.letterbox_geometry(*frame.shape[:2], IMGSZ, rect=rect)
    m, noise = detection_margins(jax.tree.map(jnp.asarray, files["yparams"]),
                                 P.yolo_params_from_jax(files["yparams"], spec), frame, geom,
                                 (0,), conf_t, 0.7, 300, gates=(0.35,))
    assert_clear(m, noise, ("gate", "order", "iou", "round"))
    return m


def test_precomputed_bboxes_image_and_video(files):
    """BASELINE config 1 (boxes given, no detector), image and video mode."""
    img = frame_of()
    boxes = np.array([[40, 30, 160, 200, 0.9], [150, 60, 300, 230, 0.8]], np.float32)
    kp = Keypoints()
    for kw in ({"is_video": False}, {"is_video": True}):
        j, p = pair(files["npz"], **kw)
        for t in range(3 if kw["is_video"] else 1):
            b = boxes + np.float32([3 * t, 2 * t, 3 * t, 2 * t, 0])
            kp.add(j.inference(img, bboxes=b), p.inference(img, bboxes=b))
            np.testing.assert_array_equal(p._tracker_res[0], j._tracker_res[0])
            assert p._tracker_res[1] == j._tracker_res[1]
        assert p.draw(show_yolo=True, confidence_threshold=-1.0).shape == img.shape
    kp.check(min_people=8)


def test_pth_checkpoint_equals_npz(files):
    img = frame_of(1)
    boxes = np.array([[40, 30, 160, 200, 0.9]], np.float32)
    a = PVI(files["npz"], model_name="s", model_cfg=PCASES["tiny"], device="cpu")
    b = PVI(files["pth"], model_name="s", model_cfg=PCASES["tiny"], device="cpu")
    for k, v in a._model.state_dict().items():
        assert torch.equal(v, b._model.state_dict()[k]), k
    np.testing.assert_array_equal(a.inference(img, bboxes=boxes)[0],
                                  b.inference(img, bboxes=boxes)[0])


class CountingDetector:
    """tests/test_pipeline_semantics.py's stub: counts calls, one box."""

    def __init__(self):
        self.calls = 0
        self.conf = 0.25

    def __call__(self, img, frame_hw=None):
        self.calls += 1
        return np.array([[50, 40, 150, 200, 0.9, 0]], np.float32)


def test_yolo_step_cadence_and_coasting(files):
    """Detections on frames 0, 1, 2 and then every yolo_step; the track
    coasts between them with the same ID and keypoints in both packages."""
    j, p = pair(files["npz"], is_video=True, yolo_step=4)
    j._detector, p._detector = CountingDetector(), CountingDetector()
    img = frame_of()
    kp = Keypoints()
    for _ in range(12):
        a, b = j.inference(img), p.inference(img)
        kp.add(a, b)
        assert p.frame_counter == j.frame_counter
    assert p._detector.calls == j._detector.calls == 5
    assert len(b) == 1
    kp.check(min_people=10)
    p.reset()
    assert p.frame_counter == 0 and p._slots_highwater == 0


@pytest.mark.parametrize("rect,shift", [(False, 12), (True, 6)])
def test_image_mode_with_detector_matches_jax(files, rect, shift):
    img = frame_of(0, shift)
    m = assert_scene_clear(files, img, rect)
    assert m["candidates"] >= 3, m
    j, p = pair(files["npz"], files["yolo"], is_video=False, yolo_rect=rect)
    assert p.single_dispatch and p.tracker is None
    kp = Keypoints()
    kp.add(j.inference(img), p.inference(img))
    np.testing.assert_allclose(p._yolo_res, j._yolo_res, atol=5e-3)
    np.testing.assert_array_equal(p._tracker_res[0], j._tracker_res[0])
    kp.check(min_people=2)


def test_video_mode_with_detector_matches_jax(files):
    """SORT over a moving scene (rect letterbox, the video default),
    detector every other frame: the same IDs on every frame."""
    frames = [frame_of(0, 6 * t) for t in range(5)]
    for f in frames[::2]:                                # the detection frames
        assert_scene_clear(files, f, rect=True)
    j, p = pair(files["npz"], files["yolo"], is_video=True, yolo_step=2)
    assert not p.single_dispatch and p.tracker is not None
    kp = Keypoints()
    for f in frames:
        a, b = j.inference(f), p.inference(f)
        kp.add(a, b)
        np.testing.assert_array_equal(p._tracker_res[0], j._tracker_res[0])
        assert p._slots_highwater == j._slots_highwater
    kp.check(min_people=4)
    assert p.draw().shape == frames[0].shape


def test_single_pose_and_det_class(files, tmp_path):
    j, p = pair(files["npz"], files["yolo"], is_video=True, single_pose=True)
    assert p.tracker is None and p.single_dispatch
    assert_scene_clear(files, frame_of(0, 6), rect=True)
    kp = Keypoints()
    kp.add(j.inference(frame_of(0, 6)), p.inference(frame_of(0, 6)))
    kp.check(min_people=2)
    # the checkpoint's dataset picks the detector's classes
    path = str(tmp_path / "vitpose-s-ap10k.npz")
    os.link(files["npz"], path)
    m = PVI(path, model_name="s", model_cfg=PCASES["tiny"], is_video=False, device="cpu")
    assert m.dataset == "ap10k" and m.det_class == "animals"
    assert m.yolo_classes == [15, 16, 17, 18, 19, 20, 21, 22, 23]


def test_fixed_slots_and_highwater(files):
    """The grow-only high-water slot bucket moves as in JAX; fixed_slots
    pins it and leaves the mark at 0."""
    for kw in ({}, {"fixed_slots": 4}):
        j, p = pair(files["npz"], files["yolo"], is_video=True, single_dispatch=True, **kw)
        for t in range(3):
            f = frame_of(0, 6 * t)
            assert_scene_clear(files, f, rect=True)
            Keypoints().add(j.inference(f), p.inference(f))
            assert p._slots_highwater == j._slots_highwater
        assert (p._slots_highwater == 0) == ("fixed_slots" in kw)


def test_fused_and_two_step_paths_equal_in_image_mode(files):
    """tests/test_fused_detect.py: the one-fetch detection frame equals
    the detect, fetch, pose path in image mode."""
    ref = PVI(files["npz"], yolo=files["yolo"], model_name="s", model_cfg=PCASES["tiny"],
              yolo_size=IMGSZ, device="cpu", single_dispatch=False, max_people=8)
    fus = PVI(files["npz"], yolo=files["yolo"], model_name="s", model_cfg=PCASES["tiny"],
              yolo_size=IMGSZ, device="cpu", single_dispatch=True, max_people=8)
    for seed in range(2):
        a, b = ref.inference(frame_of(seed)), fus.inference(frame_of(seed))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ref._yolo_res, fus._yolo_res)


def test_flip_test_and_smoothing_match_jax(files):
    img = frame_of(2)
    boxes = np.array([[40, 30, 160, 200, 0.9], [150, 60, 300, 230, 0.8]], np.float32)
    kp = Keypoints()
    j, p = pair(files["npz"], flip_test=True)
    kp.add(j.inference(img, bboxes=boxes), p.inference(img, bboxes=boxes))
    j, p = pair(files["npz"], is_video=True, smooth=True)
    assert p.smooth
    for t in range(4):
        b = boxes + np.float32([5 * t, 0, 5 * t, 0, 0])
        kp.add(j.inference(img, bboxes=b), p.inference(img, bboxes=b))
        assert p._smoothers.keys() == j._smoothers.keys()
    kp.check(min_people=8)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(0)
    hm = rng.random((2, 17, 64, 48)).astype(np.float32)
    hm[:, :, 30, 20] += 2.0
    a = JVI.postprocess(hm, org_w=96, org_h=128)
    b = PVI.postprocess(hm, org_w=96, org_h=128)
    assert b.shape == (2, 17, 3)
    np.testing.assert_allclose(b, a, atol=1e-4)


def test_entry_points_run_on_cuda_unless_asked(files, tmp_path):
    with pytest.raises(NotImplementedError, match="A12"):
        PVI(files["npz"], model_name="s", model_cfg=PCASES["tiny"], device="cpu", task="coco")
    with pytest.raises(ValueError, match="dtype"):
        PVI(files["npz"], model_name="s", model_cfg=PCASES["tiny"], device="cpu", dtype="fp8")
    pt = str(tmp_path / "yolov8n.pt")
    open(pt, "wb").close()
    with pytest.raises(NotImplementedError, match="A13"):
        PVI(files["npz"], yolo=pt, model_name="s", model_cfg=PCASES["tiny"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PVI(files["npz"], model_name="s", model_cfg=PCASES["tiny"])


@pytest.fixture(scope="module")
def vits(tmp_path_factory):
    """A random ViT-S in the JAX package's .npz (the CLI takes no custom
    config), as tests/test_cli.py makes it."""
    from easy_vitpose_tpu.configs import get_model_config
    from easy_vitpose_tpu.models.vitpose import init_vitpose_params
    path = str(tmp_path_factory.mktemp("vits") / "vitpose-s-coco.npz")
    save_params(path, init_vitpose_params(jax.random.PRNGKey(0), get_model_config("coco", "s")))
    return path


def test_cli_image_save_json(files, vits, tmp_path):
    """tests/test_cli.py's image run: --device cpu, --save-json,
    --save-img and --trace; the keypoints are VitInference's."""
    from easy_vitpose_tpu_torch.cli import infer
    img = frame_of(0, 12)
    path = str(tmp_path / "people.png")
    cv2.imwrite(path, img[..., ::-1])
    out = tmp_path / "out"
    infer.main(["--input", path, "--model", vits, "--model-name", "s", "--yolo",
                files["yolo"], "--yolo-size", str(IMGSZ), "--dtype", "fp32", "--device", "cpu",
                "--save-json", "--save-img", "--output-path", str(out),
                "--trace", str(tmp_path / "trace")])
    data = json.load(open(out / "people_keypoints.json"))
    assert len(data["keypoints"]) == 1 and data["skeleton"]["0"] == "nose"
    ref = PVI(vits, yolo=files["yolo"], model_name="s", yolo_size=IMGSZ,
              device="cpu").inference(img)
    assert len(ref) >= 3
    got = data["keypoints"][0]
    assert set(got) == {str(k) for k in ref}
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(got[str(k)], np.float32), v, atol=1e-4)
    assert cv2.imread(str(out / "people_out.png")).shape == img.shape
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    # the video modes' flag rules (the modes themselves: tests/test_torch_serving.py)
    for flag in (["--pipelined", "--batch", "4"], ["--batch", "4", "--target-fps", "30"]):
        with pytest.raises(SystemExit, match="--batch"):
            infer.main(["--input", path, "--model", vits, "--model-name", "s",
                        "--device", "cpu"] + flag)


def test_cli_video(files, vits, tmp_path):
    """A two-frame video: tracked keypoints per frame in the JSON and an
    annotated video written."""
    from easy_vitpose_tpu_torch.cli import infer
    path = str(tmp_path / "walk.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
    for t in range(2):
        w.write(np.ascontiguousarray(frame_of(0, 6 * t)[..., ::-1]))
    w.release()
    out = tmp_path / "out"
    infer.main(["--input", path, "--model", vits, "--model-name", "s", "--yolo", files["yolo"],
                "--yolo-size", str(IMGSZ), "--dtype", "fp32", "--device", "cpu",
                "--save-json", "--output-path", str(out)])
    data = json.load(open(out / "walk_keypoints.json"))
    assert len(data["keypoints"]) == 2 and any(data["keypoints"])
    assert os.path.getsize(out / "walk_out.mp4") > 0


def test_host_tier_copies_equal_jax(files):
    """configs, skeletons, the .npz format and the .pth converter: the
    port's own copies give the JAX package's results."""
    from easy_vitpose_tpu import configs as jcfg
    from easy_vitpose_tpu import skeletons as jsk
    from easy_vitpose_tpu.utils import checkpoint as jck
    from easy_vitpose_tpu_torch import configs as pcfg
    from easy_vitpose_tpu_torch import skeletons as psk
    from easy_vitpose_tpu_torch.convert import vitpose_torch as pvt
    from easy_vitpose_tpu_torch.utils import checkpoint as pck

    for name in ("vitpose-b-coco_25.pth", "/x/y/vitpose-s-ap10k.onnx", files["npz"],
                 "vitpose-h-wholebody.engine"):
        assert pcfg.infer_dataset_by_path(name) == jcfg.infer_dataset_by_path(name)
    with pytest.raises(ValueError):
        pcfg.infer_dataset_by_path("model.pth")
    assert pcfg.DETC_TO_YOLO_YOLOC == jcfg.DETC_TO_YOLO_YOLOC
    assert pcfg.MODEL_ABBR == jcfg.MODEL_ABBR
    assert psk.joints_dict() == jsk.joints_dict()
    for ds in jsk.joints_dict():
        assert psk.flip_pairs(ds) == jsk.flip_pairs(ds)
    for path in (files["npz"], files["yolo"]):
        a, b = pck.load_params(path), jck.load_params(path)
        fa, fb = pck.flatten_params(a), jck.flatten_params(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    sd, _, _ = load_case("tiny")
    got = pck.flatten_params(pvt.convert_vitpose_state_dict(sd, PCASES["tiny"]))
    want = jck.flatten_params(convert_vitpose_state_dict(sd, JCASES["tiny"]))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    bad = dict(sd)
    bad["backbone.blocks.0.attn.q_bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        pvt.convert_vitpose_state_dict(bad, PCASES["tiny"])
