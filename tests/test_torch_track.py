"""PyTorch port: the host tier of VitInference — the Kalman filter, SORT,
ByteTrack, ``track_and_cap`` and the One-Euro filter — against the JAX
package's modules on the same inputs.  The port keeps numpy copies of them
(it imports nothing of the JAX package), so everything must be equal, bit
for bit.
"""
import numpy as np
import pytest

from easy_vitpose_tpu.ops import one_euro as jeuro
from easy_vitpose_tpu.track import bytetrack as jbyte
from easy_vitpose_tpu.track import kalman as jkal
from easy_vitpose_tpu.track import sort as jsort
from easy_vitpose_tpu_torch.ops import one_euro as peuro
from easy_vitpose_tpu_torch.track import bytetrack as pbyte
from easy_vitpose_tpu_torch.track import kalman as pkal
from easy_vitpose_tpu_torch.track import sort as psort


def detection_stream(seed, frames=40, people=5):
    """Per-frame (N, 5) detections of people walking across a 640x480 frame:
    jittered boxes, missed detections, low-confidence frames (blur), a
    crossing pair, degenerate and non-finite rows, and empty frames."""
    rng = np.random.default_rng(seed)
    start = rng.uniform([0, 0], [500, 300], (people, 2))
    vel = rng.uniform(-6, 6, (people, 2))
    size = rng.uniform([30, 60], [80, 160], (people, 2))
    out = []
    for t in range(frames):
        rows = []
        for p in range(people):
            if rng.random() < 0.1:
                continue                                   # missed detection
            xy = start[p] + vel[p] * t + rng.normal(0, 1.5, 2)
            conf = rng.uniform(0.5, 0.95) if rng.random() > 0.15 else rng.uniform(0.1, 0.34)
            rows.append([xy[0], xy[1], xy[0] + size[p, 0], xy[1] + size[p, 1], conf])
        if t % 11 == 5:
            rows.append([100, 100, 90, 150, 0.9])            # degenerate
        if t % 13 == 7:
            rows.append([np.nan, 10, 20, 30, 0.8])           # non-finite
        if t % 17 == 16:
            rows = []                                        # empty frame: coast
        out.append(np.asarray(rows, np.float32).reshape(-1, 5))
    return out


def test_kalman_functions_equal():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 500, (16, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 120, (16, 2))], 1).astype(np.float32)
    np.testing.assert_array_equal(pkal.bbox_to_z(boxes), jkal.bbox_to_z(boxes))
    z = jkal.bbox_to_z(boxes)
    xj, Pj = jkal.init_state(z)
    xp, Pp = pkal.init_state(z)
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(Pp, Pj)
    for _ in range(3):
        xj, Pj = jkal.predict(xj, Pj)
        xp, Pp = pkal.predict(xp, Pp)
        zz = (z * (1 + 0.02 * rng.standard_normal(z.shape))).astype(np.float32)
        xj, Pj = jkal.update(xj, Pj, zz)
        xp, Pp = pkal.update(xp, Pp, zz)
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(Pp, Pj)
    np.testing.assert_array_equal(pkal.x_to_bbox(xp), jkal.x_to_bbox(xj))
    np.testing.assert_array_equal(pkal.iou_matrix(boxes, boxes[::-1]),
                                  jkal.iou_matrix(boxes, boxes[::-1]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate_and_sanitize_equal(seed):
    stream = detection_stream(seed)
    for a, b in zip(stream[:-1], stream[1:]):
        for x, y in zip(psort.sanitize_detections(a, return_indices=True),
                        jsort.sanitize_detections(a, return_indices=True)):
            np.testing.assert_array_equal(x, y)
        a, b = jsort.sanitize_detections(a), jsort.sanitize_detections(b)
        for x, y in zip(psort.associate(a, b, 0.3), jsort.associate(a, b, 0.3)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("tracker", ["sort", "bytetrack"])
@pytest.mark.parametrize("max_age,min_hits,cap", [(1, 3, 64), (3, 1, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_trackers_and_track_and_cap_equal(tracker, max_age, min_hits, cap, seed):
    """The same detection sequence through the port's and JAX's tracker
    and ``track_and_cap``: every frame's rows, IDs and detection indices
    equal, and the plain ``update`` (without indices) too."""
    def make(mod_sort, mod_byte):
        if tracker == "sort":
            return mod_sort.Sort(max_age=max_age, min_hits=min_hits, iou_threshold=0.3)
        return mod_byte.ByteTrack(max_age=max_age, min_hits=min_hits, iou_threshold=0.3,
                                  high_thresh=0.35, det_stride=max_age)

    tp, tj = make(psort, pbyte), make(jsort, jbyte)
    up, uj = make(psort, pbyte), make(jsort, jbyte)
    ids = set()
    for dets in detection_stream(seed):
        if tracker == "sort":
            dets = dets[~(dets[:, 4] <= 0.35)]               # the pipeline's gate
        rp, ip = psort.track_and_cap(tp, dets, cap)
        rj, ij = jsort.track_and_cap(tj, dets, cap)
        np.testing.assert_array_equal(rp, rj)
        np.testing.assert_array_equal(ip, ij)
        ok = np.isfinite(dets[:, :4]).all(1) & (dets[:, 2] > dets[:, 0])
        np.testing.assert_array_equal(up.update(dets[ok]), uj.update(dets[ok]))
        ids |= set(rp[:, 5].astype(int).tolist())
    assert len(ids) >= 3
    # no tracker: sanitize + the highest-score cap
    dets = detection_stream(seed)[3]
    for x, y in zip(psort.track_and_cap(None, dets, 2), jsort.track_and_cap(None, dets, 2)):
        np.testing.assert_array_equal(x, y)


def test_one_euro_equal():
    rng = np.random.default_rng(0)
    x0 = rng.normal(100, 20, (17, 2))
    fp = peuro.OneEuroFilter(x0, min_cutoff=1.0, beta=0.5, fps=25.0)
    fj = jeuro.OneEuroFilter(x0, min_cutoff=1.0, beta=0.5, fps=25.0)
    gp = peuro.OneEuroFilter(x0, fps=None)
    gj = jeuro.OneEuroFilter(x0, fps=None)
    for t in range(1, 30):
        x = x0 + rng.normal(0, 3, x0.shape) + t
        np.testing.assert_array_equal(fp(x), fj(x))
        np.testing.assert_array_equal(gp(x, t / 30.0), gj(x, t / 30.0))
    # per-track smoothing: a track appears, disappears and comes back
    sp, sj = {}, {}
    for t in range(12):
        kps = {pid: rng.normal(50 * pid, 5, (17, 3)).astype(np.float32)
               for pid in (1, 2, 3) if not (pid == 2 and 4 <= t < 7)}
        a = peuro.apply_track_smoothing(kps, sp, fps=30.0)
        b = jeuro.apply_track_smoothing(kps, sj, fps=30.0)
        assert a.keys() == b.keys() and sp.keys() == sj.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
