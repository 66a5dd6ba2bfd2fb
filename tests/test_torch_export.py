"""PyTorch port: the ONNX export, the ONNX interpreter, the ``.pt2`` export
and cli/export.py against the JAX package, on the CPU.

* ONNX: the port's bytes equal JAX's ``vitpose_to_onnx`` bytes for the
  same weights (the port's weights go through ``state_dict_to_jax``, which
  moves elements only); the port's interpreter gives JAX's interpreter's
  arrays bit for bit, and the port's plain forward within the JAX test's
  rel 1e-4 (tests/test_onnx_export.py).
* ``.pt2``: written by the CLI (``--device cpu``), loaded with
  ``torch.export.load`` alone, and held to JAX's ``vitpose_forward`` at fp32
  (block ``xla``; tests/test_torch_model.py's atol 1e-5 of the heatmap
  scale, rtol 1e-4) and at int8 (block ``xla_q8`` on JAX's int8 params;
  tests/test_torch_pose_step.py's 0.02 of the f32 heatmap range), and to
  the port's own plain forward bit for bit.
* The CLI's flag refusals are JAX's (tests/test_onnx_export.py:218-245).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easy_vitpose_tpu_torch.configs as pconfigs
from easy_vitpose_tpu.export.onnx_ref import run_model as jrun_model
from easy_vitpose_tpu.export.onnx_vitpose import vitpose_to_onnx as jvitpose_to_onnx
from easy_vitpose_tpu.models.quant import quantize_vit_params
from easy_vitpose_tpu.models.vitpose import vitpose_forward as jforward
from easy_vitpose_tpu_torch.cli import export as export_cli
from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu_torch.convert.from_jax import state_dict_to_jax
from easy_vitpose_tpu_torch.export import onnx_proto as P
from easy_vitpose_tpu_torch.export.onnx_ref import run_model
from easy_vitpose_tpu_torch.export.onnx_vitpose import check_exportable, vitpose_to_onnx
from easy_vitpose_tpu_torch.models.vitpose import (ViTPose, init_params, serving_copy,
                                                   vitpose_forward)
from easy_vitpose_tpu_torch.utils.checkpoint import flatten_params
from tests.test_onnx_export import CFG as JCFG
from tests.test_torch_model import port_config

torch.set_num_threads(1)
PCFG = port_config(JCFG)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A random model of tests/test_onnx_export.py's config (every bias, BN
    statistic and affine random, so a swapped or transposed weight shows),
    its params in the JAX layout, and their .npz."""
    model = init_params(PCFG, 0)
    params = state_dict_to_jax(model.state_dict(), PCFG)
    path = str(tmp_path_factory.mktemp("export") / "vitpose-t-coco.npz")
    np.savez(path, **flatten_params(params))
    return {"params": params, "model": model, "npz": path}


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(42).standard_normal((2, 256, 192, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_f32(weights, crops):
    """JAX's float32 forward (block ``xla``) of the crops."""
    params = jax.tree.map(jnp.asarray, weights["params"])
    return np.asarray(jforward(params, jnp.asarray(crops), JCFG, block_impl="xla"))


def test_onnx_bytes_equal_jax(weights, crops):
    blob = vitpose_to_onnx(weights["model"])
    assert blob == jvitpose_to_onnx(weights["params"], JCFG)
    x = crops.transpose(0, 3, 1, 2)
    (got,) = run_model(blob, {"input": x})
    (ref,) = jrun_model(blob, {"input": x})
    np.testing.assert_array_equal(got, ref)           # the same numpy arithmetic
    with torch.no_grad():
        want = vitpose_forward(weights["model"], torch.from_numpy(crops)).numpy()
    assert got.shape == want.shape == (2, 5, 64, 48)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_onnx_cli_writes_the_same_bytes(weights, tmp_path, monkeypatch):
    monkeypatch.setattr(pconfigs, "get_model_config", lambda dataset, size, **kw: PCFG)
    out = tmp_path / "vitpose-t-coco.onnx"
    export_cli.main(["--model", weights["npz"], "--model-name", "b", "--format", "onnx",
                     "--out", str(out)])
    assert out.read_bytes() == jvitpose_to_onnx(weights["params"], JCFG)
    m = P.parse_model(out.read_bytes())
    assert m.opset == 17 and m.producer_name == "easy_vitpose_tpu"
    assert m.graph.inputs[0][2] == ["batch_size", 3, 256, 192]


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_pt2_matches_jax_forward(weights, crops, jax_f32, tmp_path, monkeypatch, dtype):
    monkeypatch.setattr(pconfigs, "get_model_config", lambda dataset, size, **kw: PCFG)
    out = str(tmp_path / f"vitpose-t-coco-{dtype}.pt2")
    export_cli.main(["--model", weights["npz"], "--model-name", "b", "--batch", "2",
                     "--dtype", dtype, "--device", "cpu", "--out", out])
    prog = torch.export.load(out).module()
    in_dtype = torch.float32 if dtype == "fp32" else torch.bfloat16
    x = torch.from_numpy(crops).to(in_dtype)
    with torch.no_grad():
        got = prog(x)
        plain = vitpose_forward(serving_copy(weights["model"], dtype), x, plain=True)
    assert got.dtype == in_dtype and got.shape == (2, 5, 64, 48)
    assert torch.equal(got, plain)                    # the artifact is the plain forward
    f32, got = jax_f32, got.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, f32, atol=1e-5 * max(1.0, np.abs(f32).max()), rtol=1e-4)
    else:
        params = jax.tree.map(jnp.asarray, weights["params"])
        ref = np.asarray(jforward(quantize_vit_params(params), jnp.asarray(crops, jnp.bfloat16),
                                  JCFG, block_impl="xla_q8"), np.float32)
        span = np.ptp(f32)
        assert np.abs(got - ref).max() < 0.02 * span
        assert np.abs(got - f32).max() < 0.02 * span


def test_cli_refusals_match_jax(tmp_path):
    from easy_vitpose_tpu.cli import export as jexport_cli
    for argv in (["--format", "onnx", "--dtype", "int8"], ["--format", "onnx", "--batch", "8"],
                 ["--format", "pt2"], ["--dtype", "fp16"]):
        full = ["--model", "x.npz", "--model-name", "b", *argv, "--out", str(tmp_path / "o")]
        for main in (export_cli.main, jexport_cli.main):
            with pytest.raises(SystemExit):
                main(full)
    if not torch.cuda.is_available():                 # the aot export runs on CUDA unless asked
        with pytest.raises(RuntimeError, match="CUDA"):
            export_cli.main(["--model", "vitpose-b-coco.npz", "--model-name", "b",
                             "--out", str(tmp_path / "o.pt2")])


def test_unsupported_configs_raise():
    stem = ModelConfig("t", "coco", BackboneConfig(embed_dim=64, depth=2, num_heads=4,
                                                   stem_channels=(8, 8, 8, 8)), PCFG.head)
    up = ModelConfig("t", "coco", PCFG.backbone,
                     HeadConfig(in_channels=64, num_keypoints=5, deconv_filters=(),
                                deconv_kernels=(), upsample=4, final_conv_kernel=3))
    k3 = ModelConfig("t", "coco", PCFG.backbone,
                     HeadConfig(in_channels=64, num_keypoints=5, deconv_kernels=(3, 3)))
    for cfg in (stem, up, k3):
        with pytest.raises(NotImplementedError):
            check_exportable(cfg)
        with pytest.raises(NotImplementedError):      # before any weight is read
            vitpose_to_onnx(types.SimpleNamespace(cfg=cfg))
    for cfg in (stem, up):            # the port builds both; the ONNX export refuses them
        with pytest.raises(NotImplementedError, match="no ONNX export"):
            vitpose_to_onnx(ViTPose(cfg))
