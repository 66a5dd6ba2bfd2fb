"""PyTorch port: the batched detector (``detect_batch_core``,
``YoloDetector.detect_batch_async`` / ``unpack_batch`` / ``detect_batch``)
against JAX's ``detect_batch_jit`` and ``YoloDetector``, and the S-frame
forms of D1's and D2's plain versions against their per-frame forms, on
the CPU (where the wrappers take their plain versions).

Mirrors tests/test_multistream.py::test_detect_batch_matches_single.  As in
tests/test_torch_detect.py, every frame's ``detection_margins`` are
asserted clear of the measured port-vs-JAX noise, so the decisions
(classes, validity, order) are compared exactly and the values within
that test's tolerances (scores 5e-5, boxes 5e-3 input px).  A frame of
the stack gives its single-frame detections: decisions exactly, values
within the same tolerances (the convolutions run at another batch size).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.convert.yolo_torch import save_yolo_npz
from easy_vitpose_tpu.detect import yolo as J
from easy_vitpose_tpu_torch.detect import yolo as P
from tests.test_torch_detect import (BOX_TOL, SCORE_TOL, SPEC, assert_clear, candidates,
                                     detection_margins, weights)
from tests.test_torch_inference import IMGSZ, frame_of

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    """tests/test_torch_inference.py's moving scene, three frames of it,
    and its detector's weights."""
    frames = np.stack([frame_of(0, shift) for shift in (6, 12, 18)])
    params, model, jparams = weights(0, frame_of(0), IMGSZ)
    return frames, params, model, jparams


def assert_packed_close(got, ref, r):
    np.testing.assert_array_equal(got[..., 5:], ref[..., 5:])       # classes and validity
    np.testing.assert_allclose(got[..., 4], ref[..., 4], atol=SCORE_TOL)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=BOX_TOL / r)


@pytest.mark.parametrize("rect,classes,conf_t", [(False, (0,), 0.25), (True, (0,), 0.25)])
def test_detect_batch_core_matches_jax_and_single(net, rect, classes, conf_t):
    frames, _, model, jparams = net
    geom = J.letterbox_geometry(*frames.shape[1:3], IMGSZ, rect=rect)
    for f in frames:
        m, noise = detection_margins(jparams, model, f, geom, classes, conf_t, 0.7, 300)
        assert m["candidates"] >= 3, m
        assert_clear(m, noise)
    ref = np.asarray(J.detect_batch_jit(jparams, jnp.asarray(frames), geom, SPEC, IMGSZ,
                                        classes, conf_t, 0.7, 300, jnp.float32))
    got = P.detect_batch_core(model, torch.from_numpy(frames), geom, SPEC, classes, conf_t,
                              0.7, 300, torch.float32).numpy()
    assert got.shape == ref.shape == (3, 300, 7)
    assert (ref[:, :, 6].sum(1) > 0).all()
    assert_packed_close(got, ref, geom[0])
    for s, f in enumerate(frames):
        one = P.detect_frame_core(model, torch.from_numpy(f), geom, SPEC, IMGSZ, classes,
                                  conf_t, 0.7, 300, torch.float32).numpy()
        assert_packed_close(got[s], one, geom[0])
    plain = P.detect_batch_core(model, torch.from_numpy(frames), geom, SPEC, classes, conf_t,
                                0.7, 300, torch.float32, plain=True).numpy()
    np.testing.assert_array_equal(plain, got)


def test_unpack_batch_matches_jax():
    rng = np.random.default_rng(0)
    packed = rng.uniform(-20, 400, (3, 12, 7)).astype(np.float32)
    packed[..., 6] = rng.random((3, 12)) > 0.4
    packed[1, :, 6] = 0                                # a frame with nothing kept
    got = P.YoloDetector.unpack_batch(packed, (240, 320))
    ref = J.YoloDetector.unpack_batch(packed, (240, 320))
    assert len(got) == len(ref) == 3 and got[1].shape == (0, 6)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_detector_detect_batch_matches_single_and_jax(net, tmp_path):
    """tests/test_multistream.py::test_detect_batch_matches_single, on the
    port's detector, and against JAX's ``detect_batch``."""
    frames, params, _, _ = net
    path = str(tmp_path / "yolov8n.npz")
    save_yolo_npz(path, params, "n", 80)
    det = P.YoloDetector(path, imgsz=IMGSZ, classes=(0,), conf=0.25, device="cpu")
    jdet = J.YoloDetector(path, imgsz=IMGSZ, classes=(0,), conf=0.25)
    batched = det.detect_batch(frames)
    ref = jdet.detect_batch(frames)
    assert len(batched) == len(ref) == 3
    for s, (b, a) in enumerate(zip(batched, ref)):
        assert b.shape == a.shape and len(b) > 0
        np.testing.assert_allclose(b, a, atol=BOX_TOL / 0.4)
        np.testing.assert_allclose(b, det(frames[s]), atol=BOX_TOL / 0.4)
    packed = det.detect_batch_async(frames)
    assert packed.shape == (3, 300, 7) and packed.device.type == "cpu"


@pytest.mark.parametrize("rect", [False, True])
def test_letterbox_stack_plain_equals_per_frame(rect):
    frames = np.random.default_rng(1).integers(0, 256, (3, 37, 61, 3), dtype=np.uint8)
    geom = P.letterbox_geometry(37, 61, 96, rect=rect)
    for dt in (torch.float32, torch.bfloat16):
        x = P.letterbox_input(torch.from_numpy(frames), geom, dt)    # CPU: the plain version
        assert x.shape == (3, 3, geom[6], geom[5]) and x.dtype == dt
        assert x.is_contiguous(memory_format=torch.channels_last)
        for s in range(3):
            one = P.letterbox_input(torch.from_numpy(frames[s]), geom, dt)
            assert torch.equal(x[s:s + 1], one)


@pytest.mark.parametrize("max_det", [300, 60])
def test_nms_stack_plain_equals_per_frame(max_det):
    """The (S, A) candidates' sort along the last axis keeps each frame's
    tie order (mass ties above the gate), and D2's plain version over (S, k)
    is each frame's."""
    sets = [candidates(s, n=150, ties=bool(s % 2)) for s in range(3)]
    boxes, scores, cls = (torch.from_numpy(np.stack(a)) for a in zip(*sets))
    cand = P.nms_candidates(boxes, scores, cls, 0.25, max_det)
    got = P.nms_packed(*cand, max_det, 0.7, 7, 70, 0.3)          # CPU: the plain version
    assert got.shape == (3, max_det, 7)
    for s in range(3):
        one = P.nms_candidates(boxes[s], scores[s], cls[s], 0.25, max_det)
        for a, b in zip(cand, one):
            assert torch.equal(a[s], b)
        assert torch.equal(got[s], P.nms_packed(*one, max_det, 0.7, 7, 70, 0.3))
        ref = J.nms_fixed(jnp.asarray(sets[s][0]), jnp.asarray(sets[s][1]),
                          jnp.asarray(sets[s][2]), iou_threshold=0.7, conf_threshold=0.25,
                          max_det=max_det)
        np.testing.assert_array_equal(got[s, :, 6].numpy() > 0, np.asarray(ref[3]))
        np.testing.assert_array_equal(got[s, :, 4].numpy(), np.asarray(ref[1]))
