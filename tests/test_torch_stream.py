"""PyTorch port: ``pipeline/stream.py::MultiStreamPose`` and ``cli/serve.py``
against the JAX package's, on the CPU.

Mirrors tests/test_multistream.py and tests/test_multistream_fused.py:
two-program ticks (with boxes given and with the detector) against JAX's;
single-dispatch ticks with the IDs of the two-program path, their slots
keyed to the fused program's rows exactly, pipelined ticks equal to sync
ones one tick late (both kinds), coasting rows riding the fallback pose
step, the real-detector requirement, per-stream smoothing; stream-parallel
ticks over a ``batch`` mesh of two CPU entries (``mesh=``,
``--shard-streams --devices cpu cpu``) bit for bit the unsharded ticks and
against JAX's sharded class on two devices (tests/test_stream_sharded.py),
a stream count the mesh does not divide refused with JAX's message; frames
of mixed resolution refused.

The detector is the port's YOLOv8n at imgsz 160 with weights scaled on
tests/test_torch_inference.py's moving scene, fed to both packages, and
the scenes' margins are asserted against the measured port-vs-JAX noise.
Keypoints against JAX within tests/test_torch_inference.py's ``Keypoints``
bounds; the port against itself exactly where the same launches run.
"""
import json

import numpy as np
import pytest
import torch

from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict
from easy_vitpose_tpu.detect.yolo import YoloDetector as JDetector
from easy_vitpose_tpu.pipeline.stream import MultiStreamPose as JMulti
from easy_vitpose_tpu_torch.detect.yolo import YoloDetector
from easy_vitpose_tpu_torch.models.vitpose import serving_copy
from easy_vitpose_tpu_torch.ops.one_euro import OneEuroFilter
from easy_vitpose_tpu_torch.pipeline.stream import MultiStreamPose
from tests.test_model_parity import CASES as JAX_CASES
from tests.test_model_parity import load_case
from tests.test_torch_inference import (IMGSZ, Keypoints, assert_scene_clear, files,  # noqa: F401
                                        frame_of, vits)
from tests.test_torch_model import port_model
from tests.test_torch_serving import write_video

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def nets(files):
    sd, _, _ = load_case("tiny")
    params = convert_vitpose_state_dict(sd, JAX_CASES["tiny"])
    model = serving_copy(port_model(params, "tiny"), "fp32")
    kw = dict(imgsz=IMGSZ, classes=(0,), conf=0.25, rect=True)
    return {"params": params, "model": model,
            "det": YoloDetector(files["yolo"], device="cpu", **kw),
            "jdet": JDetector(files["yolo"], **kw)}


def ticks(n, streams=2):
    """Tick t: stream s shows the moving scene at 6 t + 12 s px."""
    return [[frame_of(0, 6 * t + 12 * s) for s in range(streams)] for t in range(n)]


def make(nets, jax=False, **kw):
    kw.setdefault("n_streams", 2)
    kw.setdefault("max_people_per_stream", 4)
    if jax:
        import jax.numpy as jnp
        det = kw.pop("detector", nets["jdet"])
        return JMulti(nets["params"], JAX_CASES["tiny"], detector=det,
                      compute_dtype=jnp.float32, **kw)
    return MultiStreamPose(nets["model"], detector=kw.pop("detector", nets["det"]), **kw)


def add_all(kp, a, b):
    for sa, sb in zip(a, b):
        kp.add(sa, sb)


def assert_equal_results(a, b):
    for sa, sb in zip(a, b):
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(sb[k], sa[k])


def test_two_program_ticks_match_jax(files, nets):
    seq = ticks(3)
    for frames in seq:
        for f in frames:
            assert_scene_clear(files, f, rect=True)
    j, p = make(nets, jax=True), make(nets)
    kp = Keypoints()
    for frames in seq:
        a, b = j.step(frames), p.step(frames)
        assert len(b) == 2
        add_all(kp, a, b)
    kp.check(min_people=4)


def test_boxes_given_end_to_end(nets):
    """tests/test_multistream.py::test_multistream_class_end_to_end."""
    j, p = make(nets, jax=True, detector=None), make(nets, detector=None)
    frames = [frame_of(0), frame_of(1)]
    boxes = [np.array([[30, 20, 120, 170, 0.9]], np.float32),
             np.array([[100, 10, 240, 180, 0.8]], np.float32)]
    kp = Keypoints()
    for _ in range(3):
        a = j.step(frames, [b.copy() for b in boxes])
        b = p.step(frames, [b.copy() for b in boxes])
        add_all(kp, a, b)
    assert [list(r) for r in b] == [[1], [1]]
    kp.check(min_people=6)


def test_fused_ids_match_two_program_and_jax(files, nets):
    ref, fus = make(nets), make(nets, single_dispatch=True)
    jfus = make(nets, jax=True, single_dispatch=True)
    assert fus.single_dispatch and not ref.single_dispatch and jfus.single_dispatch
    kp = Keypoints()
    for frames in ticks(4):
        a, b, c = ref.step(frames), fus.step(frames), jfus.step(frames)
        for si in range(2):
            assert set(a[si]) == set(b[si]) == set(c[si])
            for v in b[si].values():
                assert v.shape == (17, 3) and np.isfinite(v).all()
        add_all(kp, c, b)
    kp.check(min_people=4)


def test_fused_slots_match_standalone_program(nets):
    """Each track's keypoints are the fused program's row of its detection."""
    from easy_vitpose_tpu_torch.pipeline.fused_detect import detect_pose_multi
    from easy_vitpose_tpu_torch.track.sort import sanitize_detections
    fus = make(nets, single_dispatch=True)
    frames = ticks(1)[0]
    res = fus.step(frames)
    det = nets["det"]
    stack = torch.from_numpy(np.stack(frames))
    packed, kpts = detect_pose_multi(det.model, nets["model"], stack, det.geometry((240, 320)),
                                     det.spec, det.classes, det.conf, det.iou, det.max_det,
                                     det.dtype, fus.max_pp, 0.35)
    fresh = make(nets, single_dispatch=True)
    dets = YoloDetector.unpack_batch(packed.numpy(), (240, 320))
    seen = 0
    for si in range(2):
        r = dets[si]
        res_pd, kept = sanitize_detections(r[r[:, 4] > 0.35][:, :5], return_indices=True)
        rows, det_idx = fresh.trackers[si].update(res_pd, det_indices=kept)
        for row, di in zip(rows, det_idx):
            if 0 <= int(di) < fus.max_pp and int(row[5]) in res[si]:
                np.testing.assert_array_equal(res[si][int(row[5])],
                                              kpts[si * fus.max_pp + int(di)].numpy())
                seen += 1
    assert seen >= 2


class StubDetector:
    """tests/test_multistream.py's batched stub with the async/unpack protocol."""

    def __init__(self, boxes_per_stream):
        self.boxes = boxes_per_stream

    def detect_batch_async(self, frames_dev):
        mx = max(len(b) for b in self.boxes)
        packed = np.zeros((len(self.boxes), mx, 7), np.float32)
        for s, b in enumerate(self.boxes):
            packed[s, :len(b), :6] = b
            packed[s, :len(b), 6] = 1.0
        return torch.from_numpy(packed)

    @staticmethod
    def unpack_batch(packed, frame_hw):
        return YoloDetector.unpack_batch(packed, frame_hw)


@pytest.mark.parametrize("kind", ["stub", "fused"])
def test_pipelined_matches_sync(nets, kind):
    """step_pipelined gives step()'s results one tick late: a two-program
    tick (stub detector) and a single-dispatch one."""
    stub = [np.array([[30, 20, 120, 170, 0.9, 0]], np.float32),
            np.array([[100, 10, 240, 180, 0.8, 0], [5, 5, 80, 150, 0.7, 0]], np.float32)]

    def build():
        if kind == "stub":
            return make(nets, detector=StubDetector(stub))
        return make(nets, single_dispatch=True)

    seq = ticks(3)
    sync = build()
    ref = [sync.step(f) for f in seq]
    pipe = build()
    got = [pipe.step_pipelined(f) for f in seq]
    assert got[0] is None
    got = got[1:] + [pipe.flush()]
    assert pipe.flush() is None
    for a, b in zip(ref, got):
        assert_equal_results(a, b)
    assert any(ref[-1])


def test_fused_coast_rows_ride_fallback(nets):
    """Tracks emitted without an in-slot detection (coasting on a skipped
    tick, or missed by a detection tick) get keypoints from the fallback
    pose step."""
    fus = make(nets, single_dispatch=True, yolo_step=3)
    boxes = [np.array([[30, 20, 120, 170, 0.9]], np.float32),
             np.array([[100, 10, 240, 180, 0.8]], np.float32)]
    frames = ticks(1)[0]
    for _ in range(3):
        out = fus.step(frames, boxes_per_stream=[b.copy() for b in boxes])
    assert [len(r) for r in out] == [1, 1]
    # stream 1 goes dark: its detection tick finds nobody, so its track
    # coasts and is emitted without a detection
    for frames in ticks(3):
        out = fus.step([frames[0], np.zeros_like(frames[1])])
        assert isinstance(out, list) and len(out) == 2
        for r in out:
            for kp in r.values():
                assert kp.shape == (17, 3) and np.isfinite(kp).all()
    assert fus._fb_highwater > 0


def test_fused_requires_real_detector(nets):
    ms = make(nets, detector=StubDetector([np.zeros((0, 6), np.float32)] * 2),
              single_dispatch=True)
    assert not ms.single_dispatch


def test_smoothing_matches_single_filter(nets):
    """smooth=True: the per-track One-Euro recursion of the single-stream
    pipeline; first tick passes through; dead tracks drop their filters."""
    ms, raw = make(nets, detector=None, smooth=True), make(nets, detector=None)
    frames = [frame_of(0), frame_of(3)]
    boxes = [np.array([[10, 10, 90, 90, 0.9]], np.float32),
             np.array([[20, 8, 100, 88, 0.9]], np.float32)]
    sm = [ms.step(frames, boxes_per_stream=boxes) for _ in range(4)]
    rw = [raw.step(frames, boxes_per_stream=boxes) for _ in range(4)]
    tid = next(iter(rw[0][0]))
    f = None
    for t in range(4):
        if f is None:
            f = OneEuroFilter(rw[t][0][tid][:, :2])
            np.testing.assert_array_equal(sm[t][0][tid], rw[t][0][tid])
        else:
            np.testing.assert_allclose(sm[t][0][tid][:, :2], f(rw[t][0][tid][:, :2]),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(sm[t][0][tid][:, 2], rw[t][0][tid][:, 2])
    assert ms._smoothers[0]
    for _ in range(3):
        ms.step(frames, boxes_per_stream=[np.zeros((0, 5), np.float32)] * 2)
    assert not ms._smoothers[0] and not ms._smoothers[1]
    fs, fr = make(nets, single_dispatch=True, smooth=True), make(nets, single_dispatch=True)
    seq = ticks(2)
    s1, r1 = fs.step(seq[0]), fr.step(seq[0])
    assert_equal_results(r1, s1)
    s2, r2 = fs.step(seq[1]), fr.step(seq[1])
    for si in range(2):
        for tid in s2[si]:
            if tid in r1[si] and tid in r2[si]:
                want = OneEuroFilter(r1[si][tid][:, :2])(r2[si][tid][:, :2])
                np.testing.assert_allclose(s2[si][tid][:, :2], want, rtol=1e-5, atol=1e-5)


def test_mesh_and_mixed_resolution_refused(nets):
    """Stream-parallel ticks over a two-entry CPU mesh (a replica of the
    pose model and detector per entry, each block of streams through its
    own detector, pose step and fused tick): bit for bit the unsharded
    ticks, two-program, single-dispatch and pipelined, and within the pose
    step's bounds of JAX's sharded class on two devices.  A stream count
    the mesh does not divide, and frames of mixed resolution, are
    refused."""
    from easy_vitpose_tpu.parallel.mesh import make_mesh as jax_mesh
    from easy_vitpose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(axis="batch", devices=["cpu", "cpu"])
    seq = ticks(3)
    kp = Keypoints()
    j = make(nets, jax=True, mesh=jax_mesh(2, axis="batch"))
    for kw in ({}, {"single_dispatch": True}):
        a, b = make(nets, **kw), make(nets, mesh=mesh, **kw)
        assert len(b._shards) == 2 and b._shards[0] is b._shards[1]
        for frames in seq:
            ra, rb = a.step(frames), b.step(frames)
            assert_equal_results(ra, rb)
            if not kw:
                add_all(kp, j.step(frames), rb)
        a, b = make(nets, **kw), make(nets, mesh=mesh, **kw)
        for frames in seq:
            assert_equal_results(a.step_pipelined(frames) or [], b.step_pipelined(frames) or [])
        assert_equal_results(a.flush(), b.flush())
    kp.check(min_people=4)
    with pytest.raises(ValueError, match="n_streams=3 must be a multiple of mesh size 2"):
        make(nets, mesh=mesh, n_streams=3)
    # another device gets replicas of its own (the meta device: shapes only)
    far = make(nets, mesh=make_mesh(axis="batch", devices=["cpu", "meta"]))._shards
    assert far[0].model is nets["model"] and far[0].detector is nets["det"]
    assert far[1].device.type == "meta" and far[1].model.backbone.pos_embed.is_meta
    assert far[1].detector.device.type == "meta" and far[1].detector.graphs is not nets["det"].graphs
    assert far[1].detector.imgsz == nets["det"].imgsz and far[1].detector.conf == nets["det"].conf
    ms = make(nets, detector=None)
    with pytest.raises(ValueError):
        ms.step([frame_of(0), frame_of(0, h=200)], [np.zeros((0, 5), np.float32)] * 2)
    with pytest.raises(ValueError, match="2 frames"):
        ms.step([frame_of(0)], [np.zeros((0, 5), np.float32)])


def test_serve_cli_sync_and_pipelined(files, vits, tmp_path):
    """cli/serve.py on two clips: the pipelined run gives the sync run's
    keypoints, and so does ``--shard-streams`` over two CPU entries."""
    from easy_vitpose_tpu_torch.cli import serve
    paths = []
    for s in range(2):
        paths.append(str(tmp_path / f"cam{s}.mp4"))
        write_video(paths[-1], [frame_of(0, 6 * t + 12 * s) for t in range(3)])
    base = ["--inputs", *paths, "--model", vits, "--model-name", "s", "--yolo", files["yolo"],
            "--yolo-size", str(IMGSZ), "--dtype", "fp32", "--device", "cpu", "--save-json",
            "--max-people-per-stream", "4"]
    sync = serve.main(base + ["--no-pipeline", "--output-path", str(tmp_path / "a")])
    piped = serve.main(base + ["--output-path", str(tmp_path / "b")])
    assert len(sync) == len(piped) == 2
    for ls, lp in zip(sync, piped):
        assert len(ls) == len(lp) == 3
        for a, b in zip(ls, lp):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert any(len(t) for t in sync[0])
    saved = json.load(open(tmp_path / "a" / "cam1_keypoints.json"))["keypoints"]
    assert len(saved) == 3
    sharded = serve.main(base + ["--shard-streams", "--devices", "cpu", "cpu",
                                 "--output-path", str(tmp_path / "c")])
    for ls, lp in zip(sync, sharded):
        for a, b in zip(ls, lp):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
