"""PyTorch port: the HTTP endpoint (``cli/serve_http.py``) on the CPU.

Mirrors tests/test_serve_http.py against a live localhost server on an
ephemeral port (``--device cpu``): healthz, JSON bodies with boxes, client
errors, 413, 404, metrics, shape bucketing against direct inference, the
micro-batcher coalescing requests and agreeing with the plain server,
``--max-requests`` shutdown and statelessness.  ``PoseService.pose`` (what
the handler calls) is held to JAX's on the same image and boxes, within
tests/test_torch_inference.py's ``Keypoints`` bounds.

Every request has a timeout, and every server is shut down in a
``finally``.
"""
import base64
import json
import socket
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_inference import IMGSZ, Keypoints, files, vits  # noqa: F401

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
TIMEOUT = 300


def start(argv):
    """serve_http.main in a thread; returns (url, service, httpd, thread)."""
    from easy_vitpose_tpu_torch.cli import serve_http
    ready, box = threading.Event(), []
    t = threading.Thread(target=serve_http.main, args=(argv, ready, box), daemon=True)
    t.start()
    assert ready.wait(timeout=TIMEOUT), "server did not come up"
    httpd, service = box[0]
    return f"http://127.0.0.1:{httpd.server_address[1]}", service, httpd, t


def stop(httpd, thread):
    httpd.shutdown()
    thread.join(timeout=60)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(vits):
    url, service, httpd, t = start(["--model", vits, "--model-name", "s", "--port", "0",
                                    "--dtype", "fp32", "--fixed-slots", "4", "--device", "cpu"])
    try:
        yield url, service
    finally:
        stop(httpd, t)


@pytest.fixture(scope="module")
def batch_server(vits, files):
    """Micro-batching on (25 ms window, 2-frame cap), with a detector."""
    url, service, httpd, t = start(["--model", vits, "--model-name", "s", "--port", "0",
                                    "--dtype", "fp32", "--fixed-slots", "4", "--device", "cpu",
                                    "--yolo", files["yolo"], "--yolo-size", str(IMGSZ),
                                    "--batch-window-ms", "25", "--batch-max-frames", "2"])
    try:
        yield url, service
    finally:
        stop(httpd, t)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _post(url, body, content_type):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jpeg(img):
    ok, buf = cv2.imencode(".jpg", img[..., ::-1])
    assert ok
    return buf.tobytes()


def _payload(img, boxes):
    return json.dumps({"image": base64.b64encode(_jpeg(img)).decode(),
                       "boxes": boxes}).encode()


def test_healthz_reports_warm_and_metadata(server):
    code, body = _get(server[0] + "/healthz")
    assert code == 200 and body["status"] == "ok"
    assert body["dataset"] == "coco" and body["fixed_slots"] == 4
    assert server[1].model.device.type == "cpu"


def test_pose_json_body_with_precomputed_boxes(server):
    img = np.random.default_rng(0).integers(0, 255, (240, 320, 3), np.uint8)
    code, body = _post(server[0] + "/pose", _payload(img, [[40.0, 30.0, 280.0, 220.0, 0.9]]),
                       "application/json")
    assert code == 200, body
    (kp,) = body["keypoints"].values()
    assert np.asarray(kp).shape == (17, 3)
    assert body["ms"] > 0 and len(body["scores"]) == 1


@pytest.mark.parametrize("body,ctype,msg", [(None, "image/jpeg", "boxes"),
                                            (b"not an image", "image/jpeg", "")])
def test_client_errors(server, body, ctype, msg):
    """A raw image without a detector, and a body that is no image: 400."""
    if body is None:
        body = _jpeg(np.zeros((64, 64, 3), np.uint8))
    code, out = _post(server[0] + "/pose", body, ctype)
    assert code == 400 and msg in out["error"]


def test_metrics_count_requests_and_errors(server):
    before = _get(server[0] + "/metrics")[1]
    img = np.random.default_rng(3).integers(0, 255, (128, 128, 3), np.uint8)
    assert _post(server[0] + "/pose", _payload(img, [[10.0, 10.0, 100.0, 100.0, 0.9]]),
                 "application/json")[0] == 200
    assert _post(server[0] + "/pose", b"garbage", "image/jpeg")[0] == 400
    code, after = _get(server[0] + "/metrics")
    assert code == 200
    assert after["requests"] == before["requests"] + 1
    assert after["errors"] == before["errors"] + 1
    assert after["latency_ms_p95"] >= after["latency_ms_p50"] > 0


def test_oversized_body_rejected_413(server):
    host, port = server[0].replace("http://", "").split(":")
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall((f"POST /pose HTTP/1.1\r\nHost: {host}\r\nContent-Type: image/jpeg\r\n"
                   f"Content-Length: {1 << 30}\r\n\r\n").encode())
        s.sendall(b"tiny")
        resp = s.recv(4096).decode()
    assert "413" in resp.split("\r\n")[0]


def test_unknown_route_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server[0] + "/nope", timeout=60)
    assert e.value.code == 404
    code, _ = _post(server[0] + "/other", b"x", "image/jpeg")
    assert code == 404


def test_shape_bucketing_matches_direct_inference(server):
    from easy_vitpose_tpu_torch.cli.serve_http import _bucket_pad
    url, service = server
    img = np.random.default_rng(2).integers(0, 255, (233, 317, 3), np.uint8)
    padded = _bucket_pad(img)
    assert padded.shape == (256, 320, 3)
    np.testing.assert_array_equal(padded[:233, :317], img)
    assert not padded[233:].any() and not padded[:, 317:].any()
    assert _bucket_pad(padded) is padded
    boxes = np.array([[30.0, 20.0, 300.0, 215.0, 0.9]], np.float32)
    code, body = _post(url + "/pose", _payload(img, boxes.tolist()), "application/json")
    assert code == 200, body
    raw = cv2.imdecode(np.frombuffer(_jpeg(img), np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    with service._lock:
        direct = service.model.inference(raw, bboxes=boxes)
        service.model.reset()
    np.testing.assert_allclose(np.asarray(list(body["keypoints"].values())),
                               np.stack(list(direct.values())), atol=1e-4)


def test_pose_service_matches_jax(vits, files):
    """``PoseService.pose`` (the handler's entry point) against JAX's, with
    boxes and with the detector, on the bucketed 240x320 scene."""
    from easy_vitpose_tpu.cli import serve_http as jserve
    from easy_vitpose_tpu_torch.cli import serve_http as pserve
    from tests.test_torch_inference import assert_scene_clear, frame_of
    img = frame_of(0, 12)
    assert_scene_clear(files, pserve._bucket_pad(img), rect=False)
    args = SimpleNamespace(model=vits, yolo=files["yolo"], model_name="s", dataset=None,
                           yolo_size=IMGSZ, dtype="fp32", fixed_slots=8, batch_window_ms=0)
    j = jserve.PoseService(args)
    p = pserve.PoseService(SimpleNamespace(**vars(args), device="cpu"))
    kp = Keypoints()
    for boxes in (np.array([[40, 30, 160, 200, 0.9], [150, 60, 300, 230, 0.8]], np.float32),
                  None):
        a, b = j.pose(img, boxes), p.pose(img, boxes)
        assert a["scores"].keys() == b["scores"].keys()
        kp.add(a["keypoints"], b["keypoints"])
    kp.check(min_people=4)


def test_microbatch_single_request_works(batch_server):
    img = np.random.default_rng(5).integers(0, 255, (128, 128, 3), np.uint8)
    code, body = _post(batch_server[0] + "/pose",
                       _payload(img, [[10.0, 10.0, 100.0, 100.0, 0.7]]), "application/json")
    assert code == 200, body
    assert body["batched_frames"] == 1
    assert np.asarray(body["keypoints"]["0"]).shape == (17, 3)
    assert body["scores"]["0"] == pytest.approx(0.7)


def test_microbatch_detector_mode_raw_image(batch_server):
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 255, (128, 128, 3), np.uint8) for _ in range(2)]
    results = [None, None]

    def go(i):
        results[i] = _post(batch_server[0] + "/pose", _jpeg(imgs[i]), "image/jpeg")

    ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    for code, body in results:
        assert code == 200, body
        assert "keypoints" in body and "batched_frames" in body
        for kp in body["keypoints"].values():
            assert np.asarray(kp).shape == (17, 3)


def test_microbatch_coalesces_and_matches_plain(server, batch_server):
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 255, (128, 128, 3), np.uint8) for _ in range(4)]
    boxes = [[[8.0 + i, 6.0, 110.0, 120.0, 0.9]] for i in range(3)] \
        + [[[-20.0, -15.0, 400.0, 300.0, 0.9]]]
    payloads = [_payload(imgs[i], boxes[i]) for i in range(4)]
    results = [None] * 4
    for _ in range(4):
        barrier = threading.Barrier(4)

        def go(i):
            barrier.wait(timeout=60)
            results[i] = _post(batch_server[0] + "/pose", payloads[i], "application/json")

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert all(r is not None and r[0] == 200 for r in results), results
        if any(r[1]["batched_frames"] == 2 for r in results):
            break
    else:
        raise AssertionError("no pair coalesced in 4 barrier-synchronized rounds")
    for i in range(4):
        code, plain = _post(server[0] + "/pose", payloads[i], "application/json")
        assert code == 200
        np.testing.assert_allclose(np.asarray(results[i][1]["keypoints"]["0"]),
                                   np.asarray(list(plain["keypoints"].values())[0]), atol=1e-3)


def test_max_requests_shuts_down_cleanly(vits):
    url, _, httpd, t = start(["--model", vits, "--model-name", "s", "--port", "0",
                              "--dtype", "fp32", "--fixed-slots", "4", "--device", "cpu",
                              "--max-requests", "1", "--warmup-shapes", "100x150"])
    try:
        img = np.zeros((128, 128, 3), np.uint8)
        code, _ = _post(url + "/pose", _payload(img, [[10.0, 10.0, 100.0, 100.0, 0.9]]),
                        "application/json")
        assert code == 200
        t.join(timeout=120)
        assert not t.is_alive(), "server did not shut down after max-requests"
    finally:
        if t.is_alive():
            stop(httpd, t)


def test_requests_are_stateless_and_repeatable(server):
    img = np.random.default_rng(1).integers(0, 255, (240, 320, 3), np.uint8)
    payload = _payload(img, [[40.0, 30.0, 280.0, 220.0, 0.9]])
    _, a = _post(server[0] + "/pose", payload, "application/json")
    _, b = _post(server[0] + "/pose", payload, "application/json")
    assert list(a["keypoints"]) == list(b["keypoints"])
    np.testing.assert_array_equal(np.asarray(list(a["keypoints"].values())),
                                  np.asarray(list(b["keypoints"].values())))
