"""PyTorch port: cli/download — the model-zoo fetcher — on the CPU.

The local-server cases of tests/test_download.py against the port's
``cli/download.py``: a localhost http.server stands in for the HuggingFace
zoo (nothing here reaches the network), so the tests exercise the real code
path (urllib streaming, .part atomicity, skip/force, one-step --convert
through the port's converters) against the zoo's file layout; the
converted files load into the port's ``VitInference`` and equal the
JAX package's conversion of the same files.
"""
import http.server
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from easy_vitpose_tpu_torch.cli.download import (  # noqa: E402
    fetch, main as download_main, vitpose_zoo_path, yolo_zoo_path)
from tests.test_model_parity import CASES as JCASES  # noqa: E402
from tests.test_model_parity import load_case  # noqa: E402
from tests.test_torch_model import CASES  # noqa: E402


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A local directory mimicking JunkyByte/easy_ViTPose, served over HTTP."""
    root = tmp_path_factory.mktemp("zoo")
    # torch/coco/vitpose-s-coco.pth — tiny-geometry state dict (same fixture
    # family as test_convert_files).
    sd, _, _ = load_case("tiny")
    vp = root / vitpose_zoo_path("coco", "s")
    vp.parent.mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(vp))
    # yolov8/yolov8n.pt — ultralytics-layout pickle.
    from tests.test_convert_files import FakeUltralyticsModel
    from tests.test_yolo_torch_parity import TYolo, _ultra_state_dict
    from easy_vitpose_tpu.detect.yolo import YoloSpec
    torch.manual_seed(0)
    tm = TYolo(YoloSpec("n"))
    tm.eval()
    ysd = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
           for k, v in _ultra_state_dict(tm).items()}
    yp = root / yolo_zoo_path("n")
    yp.parent.mkdir(parents=True)
    torch.save({"model": FakeUltralyticsModel(ysd), "train_args": {}}, str(yp))

    handler = lambda *a, **k: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(root), **k)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield {"root": root, "url": f"http://127.0.0.1:{srv.server_address[1]}"}
    srv.shutdown()


def test_fetch_streams_and_is_byte_exact(zoo, tmp_path):
    rel = vitpose_zoo_path("coco", "s")
    dest = str(tmp_path / "vitpose-s-coco.pth")
    out = fetch(f"{zoo['url']}/{rel}", dest, quiet=True)
    assert out == dest
    assert not os.path.exists(dest + ".part")
    assert (open(dest, "rb").read() ==
            open(zoo["root"] / rel, "rb").read())


def test_fetch_skips_existing_unless_force(zoo, tmp_path):
    rel = yolo_zoo_path("n")
    dest = str(tmp_path / "yolov8n.pt")
    open(dest, "wb").write(b"sentinel")
    fetch(f"{zoo['url']}/{rel}", dest, quiet=True)
    assert open(dest, "rb").read() == b"sentinel"  # untouched
    fetch(f"{zoo['url']}/{rel}", dest, quiet=True, force=True)
    assert open(dest, "rb").read() == open(zoo["root"] / rel, "rb").read()


def test_fetch_404_exits_with_guidance(zoo, tmp_path):
    with pytest.raises(SystemExit, match="download failed"):
        fetch(f"{zoo['url']}/torch/coco/nope.pth", str(tmp_path / "n.pth"),
              quiet=True)
    assert not os.path.exists(tmp_path / "n.pth.part")


def test_cli_downloads_and_converts_both(zoo, tmp_path):
    """Full UX: one command leaves .pth/.pt AND ready-to-serve .npz files,
    and the converted model actually runs inference."""
    dest = str(tmp_path / "models")
    got = download_main(
        ["--model-name", "s", "--dataset", "coco", "--yolo-size", "n",
         "--dest", dest, "--base-url", zoo["url"], "--convert", "--quiet"],
        model_cfg=CASES["tiny"])
    assert sorted(os.path.basename(g) for g in got) == [
        "vitpose-s-coco.pth", "yolov8n.pt"]
    assert os.path.exists(os.path.join(dest, "vitpose-s-coco.npz"))
    assert os.path.exists(os.path.join(dest, "yolov8n.npz"))

    from easy_vitpose_tpu.convert.vitpose_torch import load_torch_checkpoint
    from easy_vitpose_tpu.convert.yolo_torch import load_ultralytics_checkpoint
    from easy_vitpose_tpu.utils.checkpoint import flatten_params
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference
    from easy_vitpose_tpu_torch.utils.checkpoint import load_params
    jax_vit = load_torch_checkpoint(os.path.join(dest, "vitpose-s-coco.pth"), JCASES["tiny"])
    jax_yolo = load_ultralytics_checkpoint(os.path.join(dest, "yolov8n.pt"))[0]
    for npz, ref in (("vitpose-s-coco.npz", jax_vit), ("yolov8n.npz", jax_yolo)):
        got = flatten_params(load_params(os.path.join(dest, npz)))
        want = flatten_params(ref)
        assert set(want) <= set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    m = VitInference(os.path.join(dest, "vitpose-s-coco.npz"),
                     model_name="s", model_cfg=CASES["tiny"], device="cpu")
    frame = np.random.default_rng(0).integers(
        0, 255, (240, 320, 3), np.uint8)
    out = m.inference(frame, bboxes=np.array([[40, 30, 200, 220, 0.9]],
                                             np.float32))
    assert out[0].shape == (17, 3) and np.isfinite(out[0]).all()


def test_cli_requires_some_target():
    with pytest.raises(SystemExit):
        download_main(["--dest", "x"])
