"""PyTorch port: the YOLOv8 detector (detect/yolo.py) against the JAX one.

Everything runs on the CPU, where the letterbox (D1) and NMS (D2) wrappers
take their plain versions.  Weights are the port's ``init_yolo_params``
(numpy, from a seed, scaled on the test's own frame so that scores spread
over (0, 1)), fed to both packages as the same arrays.

Random weights give near-tied scores (tests/test_yolo.py:242).  Where the
detector's output decides what is compared, :func:`detection_margins`
computes on the JAX side how far every score is from each gate, every
candidate from its neighbour in score order and from its runner-up class,
and every candidate pair's IoU from the NMS threshold, measures the port's
distance from JAX in the same quantities, and the test asserts that each
margin is at least twice that noise, so the chosen scene is visible in the
test.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.detect import yolo as J
from easy_vitpose_tpu_torch.detect import yolo as P
from tests.test_yolo import _nms_numpy

torch.set_num_threads(1)
SPEC = P.YoloSpec("n")
# bounds on port-vs-JAX differences at f32, after the measured noise of the
# test's scenes (scores 1e-5, boxes 2e-3 input px)
SCORE_TOL, BOX_TOL = 5e-5, 5e-3


def scene(seed=0, h=120, w=200):
    """A smooth synthetic RGB frame (the JAX tests' pattern)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([np.sin(xx / (11 + seed)), np.cos(yy / (13 + seed)),
                  np.sin((xx + yy) / (17 + seed))], -1)
    return ((f - f.min()) / (np.ptp(f) + 1e-9) * 255).astype(np.uint8)


def weights(seed, frame, imgsz, cls_gain=0.75):
    params = P.init_yolo_params(seed, SPEC, frame, imgsz, cls_gain=cls_gain)
    return params, P.yolo_params_from_jax(params, SPEC), jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def net():
    frame = scene(0)
    params, model, jparams = weights(0, frame, 128)
    return frame, params, model, jparams


def scores_of(boxes, scores, classes):
    boxes, scores = np.asarray(boxes[0]), np.asarray(scores[0])
    if classes is not None:
        sel = np.zeros(SPEC.nc, bool)
        sel[list(classes)] = True
        scores = np.where(sel[None], scores, 0.0)
    return boxes, scores


def both_scores(jparams, model, frame, geom, classes=None):
    """(boxes (A, 4), scores (A, nc)) before NMS: JAX's and the port's."""
    r, nw, nh, left, top, cw, ch = geom
    img = J.letterbox_sample(jnp.asarray(frame), (cw, ch), r, nw, nh, left, top)
    outs = J.yolo_forward(jparams, (img / 255.0).astype(jnp.float32)[None], SPEC)
    ref = scores_of(*J.decode_detections(outs, SPEC.nc), classes)
    x = P.letterbox_input_plain(torch.from_numpy(frame), geom)
    outs = P.yolo_forward(model, x.permute(0, 2, 3, 1))
    got = scores_of(*P.decode_detections(outs, SPEC.nc), classes)
    return ref, got


def _quantities(boxes, scores, cand, geom, frame_hw, iou_t):
    """What the detections' decisions read, for the candidates ``cand``:
    the top-1 and top-2 class scores, the IoU of same-class pairs and the
    un-letterboxed, frame-clipped boxes."""
    top2 = np.sort(scores, -1)[:, -2:]
    cls = np.argmax(scores, -1)
    b = boxes[cand].astype(np.float64)
    x1, y1, x2, y2 = b.T
    area = (x2 - x1) * (y2 - y1)
    inter = (np.clip(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1), 0, None)
             * np.clip(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1), 0, None))
    iou = inter / (area[:, None] + area[None] - inter)
    pairs = np.triu(cls[cand][:, None] == cls[cand][None], 1)
    r, _, _, left, top = geom[:5]
    ub = np.clip((b - [left, top, left, top]) / r, 0, [frame_hw[1], frame_hw[0]] * 2)
    return top2, iou[pairs], ub


def detection_margins(jparams, model, frame, geom, classes, conf_t, iou_t, max_det, gates=()):
    """How far JAX's detections are from every decision that float noise
    could flip, and the port's measured distance from JAX in the same
    quantities.  Margins: "gate", min |score - t| over anchors and the
    gates; "class", min top-1 minus top-2 class score of the candidates;
    "order", min gap between the candidates' scores; "iou", min |IoU -
    iou_t| over candidate pairs of one class; "round", min distance of an
    un-letterboxed candidate coordinate to a half pixel (where the pose
    crop's rounding turns).  Returns (margins, noise)."""
    (bj, sj), (bp, sp) = both_scores(jparams, model, frame, geom, classes)
    conf = sj.max(-1)
    cand = np.where(conf > conf_t)[0]
    cand = cand[np.argsort(-conf[cand], kind="stable")][:max_det]
    t2j, iouj, ubj = _quantities(bj, sj, cand, geom, frame.shape, iou_t)
    t2p, ioup, ubp = _quantities(bp, sp, cand, geom, frame.shape, iou_t)
    inf = np.inf
    m = {"candidates": len(cand),
         "gate": min(float(np.abs(conf - t).min()) for t in (conf_t, *gates)),
         "class": (float((t2j[cand, 1] - t2j[cand, 0]).min())
                   if len(cand) and (classes is None or len(classes) > 1) else inf),
         "order": float(np.diff(-conf[cand]).min()) if len(cand) > 1 else inf,
         "iou": float(np.abs(iouj - iou_t).min()) if len(iouj) else inf,
         "round": float(np.abs(np.abs(ubj - np.floor(ubj)) - 0.5).min()) if len(cand) else inf}
    score_noise = float(np.abs(sp - sj).max())
    noise = {"gate": score_noise, "class": 2 * score_noise, "order": 2 * score_noise,
             "iou": float(np.abs(ioup - iouj).max()) if len(iouj) else 0.0,
             "round": float(np.abs(ubp - ubj).max()) if len(cand) else 0.0}
    return m, noise


def assert_clear(margins, noise, keys=("gate", "class", "order", "iou")):
    """Each margin at least twice the measured noise: the scene decides
    nothing by float noise."""
    for k in keys:
        assert margins[k] > 2 * noise[k], (k, margins, noise)


def test_init_params_have_jax_layout():
    ref = J.init_yolo_params(jax.random.PRNGKey(0), J.YoloSpec("n"))
    got = P.init_yolo_params(1, SPEC, imgsz=64)
    assert (jax.tree.map(lambda a: tuple(a.shape), ref)
            == jax.tree.map(lambda a: tuple(a.shape), got))
    assert SPEC.widths == J.YoloSpec("n").widths and SPEC.depths == J.YoloSpec("n").depths
    for s in "nsmlx":
        assert P.detect_head_channels(P.YoloSpec(s)) == J.detect_head_channels(J.YoloSpec(s))


def test_yolo_forward_matches_jax_f32(net):
    _, _, model, jparams = net
    x = np.random.default_rng(3).random((1, 96, 128, 3), dtype=np.float32)
    ref = J.yolo_forward(jparams, jnp.asarray(x), SPEC)
    got = P.yolo_forward(model, torch.from_numpy(x))
    assert len(got) == 3
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert b.shape == a.shape
        # float32 convolutions summed in another order: 1e-5 of the level's range
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5 * np.abs(a).max())


def test_yolo_forward_bf16_close_to_jax(net):
    _, params, _, jparams = net
    model = P.yolo_params_from_jax(params, SPEC, torch.bfloat16)
    x = np.random.default_rng(4).random((1, 64, 96, 3), dtype=np.float32)
    ref = J.yolo_forward(jparams, jnp.asarray(x, jnp.bfloat16), SPEC)
    f32 = J.yolo_forward(jparams, jnp.asarray(x), SPEC)
    got = P.yolo_forward(model, torch.from_numpy(x).to(torch.bfloat16))
    for a, a32, b in zip(ref, f32, got):
        assert b.dtype == torch.bfloat16
        span = np.ptp(np.asarray(a32))
        # bf16 rounds at other points in the two frameworks (XLA's bf16
        # convolutions on the CPU): 0.1 of the f32 level's range
        assert np.abs(b.float().numpy() - np.asarray(a, np.float32)).max() < 0.1 * span
        assert np.abs(b.float().numpy() - np.asarray(a32)).max() < 0.1 * span


def test_decode_detections_matches_jax(net):
    _, _, model, jparams = net
    x = np.random.default_rng(5).random((2, 64, 128, 3), dtype=np.float32)
    outs = [np.asarray(o) for o in J.yolo_forward(jparams, jnp.asarray(x), SPEC)]
    bj, sj = J.decode_detections([jnp.asarray(o) for o in outs], SPEC.nc)
    bp, sp = P.decode_detections([torch.from_numpy(o.copy()) for o in outs], SPEC.nc)
    assert bp.dtype == sp.dtype == torch.float32
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), atol=BOX_TOL)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=SCORE_TOL)


def test_letterbox_geometry_exact():
    rng = np.random.default_rng(0)
    cases = [(480, 640, 320), (1080, 1920, 320), (1080, 1920, 640), (720, 1280, 640),
             (31, 97, 64), (97, 31, 64), (1, 1, 32), (333, 333, 160)]
    cases += [tuple(int(v) for v in rng.integers(1, 2000, 2)) + (int(rng.choice([64, 160, 320, 640])),)
              for _ in range(300)]
    for (h, w, imgsz), rect in itertools.product(cases, (False, True)):
        assert (P.letterbox_geometry(h, w, imgsz, rect=rect)
                == J.letterbox_geometry(h, w, imgsz, rect=rect)), (h, w, imgsz, rect)


@pytest.mark.parametrize("hw,imgsz,rect", [((90, 160), 128, False), ((90, 160), 128, True),
                                           ((37, 61), 96, False), ((200, 90), 64, True)])
def test_letterbox_sample_plain_is_jax_bits(hw, imgsz, rect):
    frame = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    geom = J.letterbox_geometry(*hw, imgsz, rect=rect)
    r, nw, nh, left, top, cw, ch = geom
    ref = np.asarray(J.letterbox_sample(jnp.asarray(frame), (cw, ch), r, nw, nh, left, top))
    got = P.letterbox_sample_plain(torch.from_numpy(frame), (cw, ch), r, nw, nh, left, top)
    np.testing.assert_array_equal(got.numpy(), ref)   # the same float32 ops: bit for bit
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        x = P.letterbox_input(torch.from_numpy(frame), geom, dt)     # CPU: the plain version
        assert x.shape == (1, 3, ch, cw) and x.dtype == dt
        assert x.is_contiguous(memory_format=torch.channels_last)
        want = np.asarray((jnp.asarray(ref) / 255.0).astype(jdt).astype(jnp.float32))
        np.testing.assert_array_equal(x[0].permute(1, 2, 0).float().numpy(), want)


def candidates(seed, n=200, classes=3, ties=False):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 300, (n, 2))
    wh = rng.uniform(10, 60, (n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    if ties:
        scores[::3] = 0.6                # mass ties above the gate
    cls = rng.integers(0, classes, n).astype(np.int32)
    return boxes, scores, cls


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("max_det,ties", [(300, False), (300, True), (60, False), (200, True)])
def test_nms_fixed_plain_is_jax(agnostic, max_det, ties):
    """k = min(max_det, A): A=200 < 300 pads (the fill of -1 makes every
    sub-threshold anchor a tie), 60 cuts, 200 = A."""
    boxes, scores, cls = candidates(max_det + agnostic, ties=ties)
    kw = dict(iou_threshold=0.5, conf_threshold=0.25, max_det=max_det, class_agnostic=agnostic)
    ref = J.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), **kw)
    got = P.nms_fixed_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(cls), **kw)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # and the sequential greedy oracle (lax.top_k's order: lower index first
    # among ties), per class unless class-agnostic, where nothing is cut
    above = scores > 0.25
    if above.sum() <= max_det:
        want = []
        for c in ([None] if agnostic else np.unique(cls)):
            sel = above & ((cls == c) if c is not None else True)
            if ties:
                order = np.argsort(-scores[sel], kind="stable")
                keep = order[_greedy_in_order(boxes[sel][order], 0.5)]
            else:                         # tests/test_yolo.py's oracle
                keep = _nms_numpy(boxes[sel], scores[sel], 0.5)
            want += scores[sel][keep].tolist()
        kept = np.sort(got[1].numpy()[got[3].numpy()])[::-1]
        np.testing.assert_array_equal(kept, np.sort(np.float32(want))[::-1])


def _greedy_in_order(boxes, iou_t):
    """Greedy NMS over boxes already in score order: kept positions."""
    keep, alive = [], np.ones(len(boxes), bool)
    for i in range(len(boxes)):
        if not alive[i]:
            continue
        keep.append(i)
        b = boxes[i]
        xx1 = np.maximum(b[0], boxes[:, 0])
        yy1 = np.maximum(b[1], boxes[:, 1])
        xx2 = np.minimum(b[2], boxes[:, 2])
        yy2 = np.minimum(b[3], boxes[:, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a = (b[2] - b[0]) * (b[3] - b[1])
        ar = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        alive &= ~((inter / (a + ar - inter + 1e-9) > iou_t) & (np.arange(len(boxes)) > i))
    return keep


def test_nms_packed_plain_is_jax_tail():
    """D2's plain version = JAX's nms_fixed, un-letterbox and packing of
    detect_frame_core, on the same candidates, bit for bit."""
    boxes, scores, cls = candidates(11, n=150)
    r, left, top = 0.16666666666666666, 0, 70
    b, s, c, v = J.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls),
                             iou_threshold=0.7, conf_threshold=0.25, max_det=300)
    b = (b - jnp.asarray([left, top, left, top], jnp.float32)) / r
    ref = np.asarray(jnp.concatenate([b, s[:, None], c.astype(jnp.float32)[:, None],
                                      v.astype(jnp.float32)[:, None]], axis=1))
    cand = P.nms_candidates(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(cls), 0.25, 300)
    got = P.nms_packed(*cand, 300, 0.7, left, top, r)           # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape == (300, 7) and (got[150:, 4:] == 0).all()


@pytest.mark.parametrize("rect,classes,conf_t", [(False, None, 0.5), (True, (0,), 0.25)])
def test_detect_frame_core_matches_jax(net, rect, classes, conf_t):
    """The whole core at f32: without a class gate on the square canvas
    (conf 0.5), and with the pipeline's "human" gate on the rect one."""
    frame, _, model, jparams = net
    geom = J.letterbox_geometry(*frame.shape[:2], 128, rect=rect)
    iou_t = 0.7
    m, noise = detection_margins(jparams, model, frame, geom, classes, conf_t, iou_t, 300)
    assert m["candidates"] >= 5, m
    assert_clear(m, noise)
    ref = np.asarray(J.detect_frame_jit(jparams, jnp.asarray(frame), geom, SPEC, 128, classes,
                                        conf_t, iou_t, 300, jnp.float32))
    got = P.detect_frame_core(model, torch.from_numpy(frame), geom, SPEC, 128, classes,
                              conf_t, iou_t, 300, torch.float32).numpy()
    assert got.shape == ref.shape == (300, 7)
    assert 0 < ref[:, 6].sum() < m["candidates"] or m["candidates"] == 1
    np.testing.assert_array_equal(got[:, 5:], ref[:, 5:])          # classes and validity
    np.testing.assert_allclose(got[:, 4], ref[:, 4], atol=SCORE_TOL)
    np.testing.assert_allclose(got[:, :4], ref[:, :4], atol=BOX_TOL / geom[0])
    plain = P.detect_frame_core(model, torch.from_numpy(frame), geom, SPEC, 128, classes,
                                conf_t, iou_t, 300, torch.float32, plain=True).numpy()
    np.testing.assert_array_equal(plain, got)                      # the CPU takes the plain path


def test_detector_loads_npz_and_runs_on_cpu(tmp_path, net):
    from easy_vitpose_tpu.convert.yolo_torch import save_yolo_npz
    frame, params, _, jparams = net
    path = str(tmp_path / "yolov8n.npz")
    save_yolo_npz(path, params, "n", 80)
    det = P.YoloDetector(path, imgsz=128, conf=0.25, device="cpu")
    assert det.spec == SPEC and det.model.model["0"].weight.device.type == "cpu"
    jdet = J.YoloDetector(path, imgsz=128, conf=0.25)
    got, ref = det(frame), jdet(frame)
    assert got.shape == ref.shape and got.shape[1] == 6
    np.testing.assert_allclose(got, ref, atol=BOX_TOL / 0.64)
    # an ultralytics .pt loads (a stand-in of its pickled model) and equals its .npz
    from tests.test_torch_convert import ultralytics_pt
    from easy_vitpose_tpu_torch.convert.yolo_torch import load_ultralytics_checkpoint
    pt = ultralytics_pt(str(tmp_path / "yolov8n.pt"))
    tree, scale, nc = load_ultralytics_checkpoint(pt)
    save_yolo_npz(str(tmp_path / "from_pt.npz"), tree, scale, nc)
    det_pt = P.YoloDetector(pt, imgsz=128, conf=0.25, device="cpu")
    det_npz = P.YoloDetector(str(tmp_path / "from_pt.npz"), imgsz=128, conf=0.25, device="cpu")
    assert det_pt.spec == det_npz.spec == SPEC
    np.testing.assert_array_equal(det_pt(frame), det_npz(frame))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.YoloDetector(path)                   # the card unless asked for the CPU


def test_nms_shared_memory_bound():
    assert P.nms_smem_bytes(300) == 300 * 25 + 4 * 300 * 10      # 12 KB of bitmask at k=300
    kmax = max(k for k in range(1, 4096) if P.nms_smem_bytes(k) <= P.SMEM_LIMIT)
    assert 1200 < kmax < 1300 and P.nms_smem_bytes(kmax + 1) > P.SMEM_LIMIT
