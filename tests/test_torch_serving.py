"""PyTorch port: single-stream serving modes of ``VitInference`` and the
CLI's video flags against the JAX package, on the CPU.

* ``inference_pipelined`` / ``flush``: against JAX's, and against the
  port's own ``inference`` one frame late (the same launches, so equal).
* ``inference_batched`` / ``select_frame_state``: the six scenarios of
  tests/test_batched_inference.py (precomputed boxes, detector cadence and
  tracking, flip test, empty and single frame, fuzz, draw-state replay),
  against JAX's batched path and the port's sequential one.
* ``YoloStepAutoTuner`` and ``set_yolo_step``: tests/test_autotune.py.
* ``cli/infer.py``'s ``--pipelined``, ``--batch`` and ``--target-fps``
  and their exclusions.

The shipping dtypes (ROADMAP C12) are held in
tests/test_torch_shipping_dtypes.py.

Tolerances: keypoints against JAX as tests/test_torch_inference.py's
``Keypoints`` (scores within 1e-5, coordinates within 0.5 px except at
most 2 of a person's 17 tied peaks, median within 0.01 px); the port's
batched path against its sequential path within 1e-3 (JAX's own test's
bound; the backbone runs at another batch size).  Where the detector
decides what is compared, the scenes' margins are asserted against the
measured port-vs-JAX noise (``assert_scene_clear``).
"""
import json

import cv2
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.pipeline.autotune import YoloStepAutoTuner as JTuner
from easy_vitpose_tpu_torch.pipeline.autotune import YoloStepAutoTuner
from tests.test_torch_inference import (IMGSZ, Keypoints, assert_scene_clear, files,  # noqa: F401
                                        frame_of, pair, vits)

torch.set_num_threads(1)


def boxes_seq(n):
    """tests/test_batched_inference.py's two people drifting across frames."""
    return [np.array([[30 + 2 * i, 20, 160 + 2 * i, 200, 0.9],
                      [100, 40 + i, 280, 230, 0.8]], np.float32) for i in range(n)]


def pans(n, seed=0, h=240, w=320):
    """tests/test_batched_inference.py's noise frame in a slow pan."""
    base = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    return [np.roll(base, 3 * i, axis=1) for i in range(n)]


def video(n, step=6):
    return [frame_of(0, step * t) for t in range(n)]


def assert_same(a, b, atol=0.0):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=atol, rtol=0)


# ------------------------------------------------------------- pipelined

def test_pipelined_matches_jax_and_sequential(files):
    frames = video(5)
    for f in frames:
        assert_scene_clear(files, f, rect=True)
    j, p = pair(files["npz"], files["yolo"], is_video=True)
    _, seq = pair(files["npz"], files["yolo"], is_video=True)
    want = [seq.inference(f) for f in frames]
    states = []
    got, ref = [], []
    for f in frames:
        ref.append(j.inference_pipelined(f))
        got.append(p.inference_pipelined(f))
        if got[-1] is not None:
            states.append((p._tracker_res[0].copy(), list(p._tracker_res[1])))
    assert got[0] is None and ref[0] is None
    ref, got = ref[1:] + [j.flush()], got[1:] + [p.flush()]
    states.append((p._tracker_res[0].copy(), list(p._tracker_res[1])))
    assert p.flush() is None and p._pipe_pending is None
    kp = Keypoints()
    for t in range(len(frames)):
        kp.add(ref[t], got[t])
        assert_same(want[t], got[t])                       # the same launches: equal
    kp.check(min_people=4)
    assert p.frame_counter == seq.frame_counter == j.frame_counter == len(frames)
    np.testing.assert_array_equal(states[-1][0], seq._tracker_res[0])
    assert states[-1][1] == seq._tracker_res[1]


# --------------------------------------------------------------- batched

def test_batched_precomputed_boxes_matches_jax_and_sequential(files):
    frames, boxes = pans(7), boxes_seq(7)
    j, p = pair(files["npz"], is_video=True)
    _, seq = pair(files["npz"], is_video=True)
    want = [seq.inference(f, bboxes=b) for f, b in zip(frames, boxes)]
    got = (p.inference_batched(frames[:4], bboxes_per_frame=boxes[:4])
           + p.inference_batched(frames[4:], bboxes_per_frame=boxes[4:]))
    ref = (j.inference_batched(frames[:4], bboxes_per_frame=boxes[:4])
           + j.inference_batched(frames[4:], bboxes_per_frame=boxes[4:]))
    assert len(got) == 7 and p._batched_slots == j._batched_slots
    kp = Keypoints()
    for a, b, c in zip(want, got, ref):
        assert_same(a, b, atol=1e-3)
        kp.add(c, b)
    kp.check(min_people=14)


def test_batched_detector_cadence_and_tracking(files):
    """A live detector with yolo_step=3 across two windows: IDs per frame
    equal JAX's batched path and the port's sequential one."""
    frames = video(8, step=4)
    due = [i for i in range(8) if i < 3 or i % 3 == 0]
    for i in due:
        assert_scene_clear(files, frames[i], rect=True)
    j, p = pair(files["npz"], files["yolo"], is_video=True, yolo_step=3)
    _, seq = pair(files["npz"], files["yolo"], is_video=True, yolo_step=3)
    want = []
    for f in frames:
        seq.inference(f)
        want.append(list(seq._tracker_res[1]))
    got = p.inference_batched(frames[:5]) + p.inference_batched(frames[5:])
    ref = j.inference_batched(frames[:5]) + j.inference_batched(frames[5:])
    kp = Keypoints()
    for i in range(8):
        assert sorted(got[i]) == sorted(want[i]) == sorted(ref[i]), i
        kp.add(ref[i], got[i])
    kp.check(min_people=4)


def test_batched_flip_test(files):
    frames, boxes = pans(4), boxes_seq(4)
    j, p = pair(files["npz"], is_video=True, flip_test=True)
    _, seq = pair(files["npz"], is_video=True, flip_test=True)
    want = [seq.inference(f, bboxes=b) for f, b in zip(frames, boxes)]
    got = p.inference_batched(frames, bboxes_per_frame=boxes)
    ref = j.inference_batched(frames, bboxes_per_frame=boxes)
    kp = Keypoints()
    for a, b, c in zip(want, got, ref):
        assert_same(a, b, atol=1e-3)
        kp.add(c, b)
    kp.check(min_people=8)


def test_batched_empty_and_single_frame(files):
    _, p = pair(files["npz"], is_video=True)
    assert p.inference_batched([]) == []
    out = p.inference_batched(pans(1), bboxes_per_frame=[np.empty((0, 5), np.float32)])
    assert out == [{}]


def test_batched_fuzz_equivalence(files):
    """Random person counts per frame (empty frames too), uneven windows,
    yolo_step=2: IDs and keypoints as the sequential path and JAX's."""
    rng = np.random.default_rng(11)
    n = 13
    frames = pans(n, seed=5)
    boxes = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        x1, y1 = rng.uniform(0, 200, k), rng.uniform(0, 120, k)
        boxes.append(np.stack([x1, y1, x1 + rng.uniform(40, 110, k), y1 + rng.uniform(60, 110, k),
                               rng.uniform(0.5, 1.0, k)], -1).astype(np.float32).reshape(-1, 5))
    j, p = pair(files["npz"], is_video=True, yolo_step=2)
    _, seq = pair(files["npz"], is_video=True, yolo_step=2)
    want = [seq.inference(f, bboxes=b) for f, b in zip(frames, boxes)]
    got, ref = [], []
    for s, e in ((0, 5), (5, 6), (6, 13)):
        got += p.inference_batched(frames[s:e], bboxes_per_frame=boxes[s:e])
        ref += j.inference_batched(frames[s:e], bboxes_per_frame=boxes[s:e])
    kp = Keypoints()
    for a, b, c in zip(want, got, ref):
        assert_same(a, b, atol=1e-3)
        kp.add(c, b)
    kp.check(min_people=8)


def test_batched_draw_state_replay(files):
    frames, boxes = pans(3), boxes_seq(3)
    j, p = pair(files["npz"], is_video=True)
    outs = p.inference_batched(frames, bboxes_per_frame=boxes)
    j.inference_batched(frames, bboxes_per_frame=boxes)
    for k in range(3):
        p.select_frame_state(k)
        j.select_frame_state(k)
        assert p.draw(show_yolo=True, confidence_threshold=-1.0).shape == frames[k].shape
        assert p._keypoints == outs[k]
        np.testing.assert_array_equal(p._tracker_res[0], j._tracker_res[0])
        assert p._tracker_res[1] == j._tracker_res[1]


# -------------------------------------------------------------- autotune

def test_autotuner_matches_jax():
    """tests/test_autotune.py's scenarios, step for step against JAX's."""
    for dts, start in (([0.1] * 25 + [0.01] * 200, 1), ([1 / 31.0] * 50, 3)):
        a, b = YoloStepAutoTuner(target_fps=30, adjust_every=5), JTuner(30, adjust_every=5)
        a.step = b.step = start
        sa, sb = [a.update(dt) for dt in dts], [b.update(dt) for dt in dts]
        assert sa == sb
    t = YoloStepAutoTuner(target_fps=30, adjust_every=5)
    steps = [t.update(0.1) for _ in range(25)]
    assert steps[0] < steps[-1] <= t.max_step
    for _ in range(200):
        t.update(0.01)
    assert t.min_step <= t.step < steps[-1]
    with pytest.raises(ValueError):
        YoloStepAutoTuner(target_fps=0)


def test_set_yolo_step_retunes_tracker(files):
    _, m = pair(files["npz"], is_video=True)
    assert m.tracker.max_age == 1 and m.tracker.min_hits == 3
    m.set_yolo_step(4)
    assert m.yolo_step == 4 and m.tracker.max_age == 4 and m.tracker.min_hits == 1
    m.set_yolo_step(1)
    assert m.tracker.max_age == 1 and m.tracker.min_hits == 3
    m.inference(np.zeros((240, 320, 3), np.uint8),
                bboxes=np.array([[30, 20, 120, 170, 0.9]], np.float32))
    before = m.tracker.ids.copy()
    assert len(before) == 1
    m.set_yolo_step(3)
    np.testing.assert_array_equal(m.tracker.ids, before)       # retuning keeps live tracks


# ------------------------------------------------------------------- CLI

def write_video(path, frames):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()


@pytest.mark.parametrize("flags", [["--pipelined"], ["--batch", "2"], ["--target-fps", "1000"]])
def test_cli_video_modes(files, vits, tmp_path, flags):
    """Each mode writes one keypoint dict per frame, equal to the plain
    per-frame run's (the pipelined and batched schedules keep the per-frame
    semantics; --target-fps only retunes the cadence, which a 3-frame clip
    never reaches)."""
    from easy_vitpose_tpu_torch.cli import infer
    path = str(tmp_path / "walk.mp4")
    write_video(path, [frame_of(0, 6 * t) for t in range(3)])
    base = ["--input", path, "--model", vits, "--model-name", "s", "--yolo", files["yolo"],
            "--yolo-size", str(IMGSZ), "--dtype", "fp32", "--device", "cpu", "--save-json"]
    infer.main(base + ["--output-path", str(tmp_path / "ref")])
    infer.main(base + flags + ["--output-path", str(tmp_path / "got")])
    ref = json.load(open(tmp_path / "ref" / "walk_keypoints.json"))["keypoints"]
    got = json.load(open(tmp_path / "got" / "walk_keypoints.json"))["keypoints"]
    assert len(got) == len(ref) == 3 and any(ref)
    for a, b in zip(ref, got):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]), atol=1e-3)


@pytest.mark.parametrize("flags,msg", [(["--batch", "4", "--pipelined"], "--batch"),
                                       (["--batch", "4", "--target-fps", "30"], "--batch"),
                                       (["--pipelined", "--single-dispatch"], "--single-dispatch"),
                                       (["--batch", "2", "--single-dispatch"], "--single-dispatch")])
def test_cli_flag_exclusions(vits, flags, msg):
    """JAX's rules, checked before any model loads or input is read."""
    from easy_vitpose_tpu_torch.cli import infer
    with pytest.raises(SystemExit, match=msg):
        infer.main(["--input", "missing.mp4", "--model", vits, "--model-name", "s",
                    "--device", "cpu"] + flags)
