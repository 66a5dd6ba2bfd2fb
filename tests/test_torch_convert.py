"""PyTorch port: cli/convert.py and the converters against the JAX
package's, on the CPU.

Both CLIs run on the same inputs: a synthetic reference-format ``.pth``,
the synthetic ViTPose+ state dict of tests/test_torch_plus.py and a
stand-in ultralytics YOLOv8n ``.pt`` (the pickled module of
tests/test_convert_files.py).  Every subcommand must write files with the
same keys and bit-equal arrays (both CLIs only move, fold and average
float32 arrays with numpy, in the same order).  The model configs are the
tiny ones of tests/test_torch_plus.py, patched in for the CLIs' own
``get_model_config``.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

import easy_vitpose_tpu.cli.convert as jcli
import easy_vitpose_tpu.configs as jconfigs
import easy_vitpose_tpu_torch.cli.convert as pcli
import easy_vitpose_tpu_torch.configs as pconfigs
from easy_vitpose_tpu.convert.vitpose_torch import export_vitpose_state_dict as jexport
from easy_vitpose_tpu_torch.convert.model_split import SPLIT_DATASETS
from easy_vitpose_tpu_torch.convert.vitpose_torch import (convert_vitpose_state_dict,
                                                         export_vitpose_state_dict)
from easy_vitpose_tpu_torch.detect import yolo as P
from easy_vitpose_tpu_torch.utils.checkpoint import flatten_params, load_params
from tests.test_convert_files import FakeUltralyticsModel
from tests.test_torch_model import port_config
from tests.test_torch_plus import JCFG, make_plus_sd

torch.set_num_threads(1)


def jax_cfg(dataset, size, *, num_keypoints=None):
    k = num_keypoints if num_keypoints is not None else jconfigs.NUM_KEYPOINTS[dataset]
    return dataclasses.replace(JCFG, name=size, dataset=dataset,
                               head=dataclasses.replace(JCFG.head, num_keypoints=k))


def port_cfg(dataset, size, *, num_keypoints=None):
    return port_config(jax_cfg(dataset, size, num_keypoints=num_keypoints))


@pytest.fixture(scope="module")
def tiny_configs():
    """Both packages' get_model_config answer with the tiny config."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfigs, "get_model_config", jax_cfg)
        mp.setattr(jcli, "get_model_config", jax_cfg)
        mp.setattr(pconfigs, "get_model_config", port_cfg)
        mp.setattr(pcli, "get_model_config", port_cfg)
        yield


def single_sd(seed=0):
    """A reference-format single-task state dict of the tiny config (the
    coco split of the ViTPose+ one, with fresh random values)."""
    from easy_vitpose_tpu_torch.convert.model_split import split_vitpose_plus
    return split_vitpose_plus(make_plus_sd(seed))["coco"]


def ultralytics_pt(path, seed=0):
    """A stand-in ultralytics YOLOv8n .pt: the torch mini-clone's state
    dict with random BN statistics, pickled in a module object."""
    from easy_vitpose_tpu.detect.yolo import YoloSpec
    from tests.test_yolo_torch_parity import TYolo, _ultra_state_dict
    torch.manual_seed(seed)
    tm = TYolo(YoloSpec("n")).eval()
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.3)
                mod.running_var.uniform_(0.5, 2.0)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _ultra_state_dict(tm).items()}
    torch.save({"model": FakeUltralyticsModel(sd), "train_args": {}}, path)
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert")
    pth = str(d / "vitpose-s-coco.pth")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v)
                               for k, v in single_sd(1).items()}}, pth)
    plus = str(d / "vitpose-plus.pth")
    torch.save({k: torch.from_numpy(v) for k, v in make_plus_sd(2).items()}, plus)
    return {"dir": d, "pth": pth, "plus": plus, "pt": ultralytics_pt(str(d / "yolov8n.pt"))}


def assert_same_npz(a, b):
    fa, fb = flatten_params(load_params(a)), flatten_params(load_params(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def assert_same_pth(a, b):
    sa = torch.load(a, weights_only=True)["state_dict"]
    sb = torch.load(b, weights_only=True)["state_dict"]
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def both(tmp, cmd, *args, out_ext=".npz"):
    """Run ``cmd`` through both CLIs, each writing its own output."""
    outs = []
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        out = os.path.join(tmp, f"{name}-{cmd}{out_ext}")
        main([cmd, *args, "--out", out])
        outs.append(out)
    return outs


def test_vitpose_and_to_torch_match_jax(tiny_configs, inputs):
    d = str(inputs["dir"])
    a, b = both(d, "vitpose", "--ckpt", inputs["pth"], "--model-name", "s",
                "--dataset", "coco")
    assert_same_npz(a, b)
    # to-torch back: the same .pth from both, the source's tensors bit for bit
    ta, tb = both(d, "to-torch", "--ckpt", b, "--model-name", "s", "--dataset", "coco",
                  out_ext=".pth")
    assert_same_pth(ta, tb)
    src = torch.load(inputs["pth"], weights_only=True)["state_dict"]
    back = torch.load(tb, weights_only=True)["state_dict"]
    assert {"module." + k for k in back} == set(src)
    for k, v in back.items():
        # the BN counters come back 1-d, as the JAX package writes them
        # (np.ascontiguousarray of a 0-d array); torch's BatchNorm loads them
        want = src["module." + k]
        assert v.dtype == want.dtype and torch.equal(v.reshape(want.shape), want), k


def test_export_state_dict_matches_jax():
    cfg = port_cfg("coco", "s")
    params = convert_vitpose_state_dict(single_sd(3), cfg)
    got, ref = export_vitpose_state_dict(params, cfg), jexport(params, jax_cfg("coco", "s"))
    assert list(got) == list(ref)
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_plus_and_split_match_jax(tiny_configs, inputs):
    d = str(inputs["dir"])
    a, b = both(d, "plus", "--ckpt", inputs["plus"], "--model-name", "s")
    assert_same_npz(a, b)
    assert sorted(load_params(b)["heads"]) == sorted(SPLIT_DATASETS)
    dirs = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        dirs[name] = os.path.join(d, f"split-{name}")
        main(["split", "--source", inputs["plus"], "--target", dirs[name], "--model-name", "s"])
    for ds in SPLIT_DATASETS:
        assert_same_npz(*(os.path.join(dirs[n], f"vitpose-s-{ds}.npz") for n in ("jax", "port")))
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))


def test_average_matches_jax(tiny_configs, inputs):
    d = str(inputs["dir"])
    ckpts = []
    for i in range(3):
        path = os.path.join(d, f"avg{i}.npz")
        params = convert_vitpose_state_dict(single_sd(10 + i), port_cfg("coco", "s"))
        params["step"] = np.asarray(100 + i, np.int32)          # an integer leaf
        np.savez(path, **flatten_params(params))
        ckpts.append(path)
    a, b = both(d, "average", "--ckpts", *ckpts)
    assert_same_npz(a, b)
    assert int(load_params(b)["step"]) == 100                    # the first one's
    odd = os.path.join(d, "odd.npz")
    params = convert_vitpose_state_dict(single_sd(4), port_cfg("coco", "s"))
    params["head"]["final_b"] = params["head"]["final_b"][:5]
    np.savez(odd, **flatten_params(params))
    for main in (jcli.main, pcli.main):
        with pytest.raises(SystemExit):
            main(["average", "--ckpts", ckpts[0], odd, "--out", os.path.join(d, "x.npz")])


def test_yolo_pt_matches_jax_and_loads_as_npz(inputs):
    d = str(inputs["dir"])
    a, b = both(d, "yolo", "--ckpt", inputs["pt"])
    assert_same_npz(a, b)
    # the port's detector on the .pt equals itself on the converted .npz
    frame = np.random.default_rng(0).integers(0, 256, (240, 320, 3), np.uint8)
    det_pt = P.YoloDetector(inputs["pt"], imgsz=160, device="cpu")
    det_npz = P.YoloDetector(b, imgsz=160, device="cpu")
    assert det_pt.spec == det_npz.spec == P.YoloSpec("n", 80)
    for k, v in det_pt.model.state_dict().items():
        assert torch.equal(v, det_npz.model.state_dict()[k]), k
    np.testing.assert_array_equal(det_pt(frame), det_npz(frame))


def test_yolo_state_dict_audit_and_missing_ultralytics(inputs, tmp_path):
    from easy_vitpose_tpu.convert import yolo_torch as J
    from easy_vitpose_tpu_torch.convert import yolo_torch as Y
    sd = torch.load(inputs["pt"], weights_only=False)["model"].state_dict()
    sd = {k: v.numpy() for k, v in sd.items()}
    assert Y.infer_scale(sd) == "n"
    extra = dict(sd, **{"model.23.conv.weight": np.zeros((1, 1, 1, 1), np.float32)})
    for mod in (J, Y):
        with pytest.raises(ValueError, match="silently drop"):
            mod.convert_yolo_state_dict(extra, mod.YoloSpec("n"))
        with pytest.raises(KeyError, match="missing expected key"):
            mod.convert_yolo_state_dict({k: v for k, v in sd.items() if "model.9." not in k},
                                        mod.YoloSpec("n"))
    # a released .pt pickles ultralytics' classes: without the package it
    # fails with the JAX package's message
    mod = types.ModuleType("ultralytics_standin")
    exec("import torch\nclass DetectionModel(torch.nn.Module):\n    pass\n", mod.__dict__)
    sys.modules[mod.__name__] = mod
    try:
        pt = str(tmp_path / "yolov8n.pt")
        torch.save({"model": mod.DetectionModel()}, pt)
    finally:
        del sys.modules[mod.__name__]
    for m in (J, Y):
        with pytest.raises(RuntimeError, match="requires the ultralytics package"):
            m.load_ultralytics_checkpoint(pt)
