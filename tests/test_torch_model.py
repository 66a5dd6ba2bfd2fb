"""PyTorch port: the ViTPose forward and the weight conversion vs the JAX
package and the reference goldens.

The goldens in tests/golden/model_{tiny,sslim}.npz hold a reference-format
state dict (``sd::`` keys), an input batch and the reference torch model's
heatmaps; the port loads the state dict with ``load_state_dict`` as it is.
Everything runs on the CPU, through the plain versions of the kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict
from easy_vitpose_tpu.models import head as jhead
from easy_vitpose_tpu.models.vitpose import init_vitpose_params
from easy_vitpose_tpu.models.vitpose import vitpose_forward as jax_vitpose_forward
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import state_dict_from_jax
from easy_vitpose_tpu_torch.models.head import head_forward
from easy_vitpose_tpu_torch.models.quant import QBlock
from easy_vitpose_tpu_torch.models.vitpose import (ViTPose, cast_params, compute_dtype,
                                                   init_params, serving_copy, vitpose_forward)
from tests.test_model_parity import CASES as JAX_CASES
from tests.test_model_parity import load_case

torch.set_num_threads(1)


def port_config(cfg) -> tc.ModelConfig:
    """The port's ModelConfig equal to a JAX package ModelConfig."""
    bb, hd = cfg.backbone, cfg.head
    return tc.ModelConfig(
        name=cfg.name, dataset=cfg.dataset,
        backbone=tc.BackboneConfig(embed_dim=bb.embed_dim, depth=bb.depth,
                                   num_heads=bb.num_heads, mlp_ratio=bb.mlp_ratio,
                                   layer_norm_eps=bb.layer_norm_eps),
        head=tc.HeadConfig(in_channels=hd.in_channels, num_keypoints=hd.num_keypoints,
                           deconv_filters=hd.deconv_filters,
                           deconv_kernels=hd.deconv_kernels,
                           final_conv_kernel=hd.final_conv_kernel))


CASES = {name: port_config(cfg) for name, cfg in JAX_CASES.items()}


def port_model(params, name: str) -> ViTPose:
    """A float32 CPU ViTPose holding the JAX params."""
    cfg = CASES[name]
    model = ViTPose(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model.eval()


def jax_params(name: str, seed: int = 0):
    return init_vitpose_params(jax.random.PRNGKey(seed), JAX_CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_reference_golden(name):
    sd, x_nchw, y_ref = load_case(name)
    model = ViTPose(CASES[name])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = torch.from_numpy(np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        y = vitpose_forward(model.eval(), x).numpy()
    assert y.shape == y_ref.shape
    # the same bound the JAX package holds to the reference (test_model_parity)
    np.testing.assert_allclose(y, y_ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    """Random JAX weights through the converter: heatmaps equal to the JAX
    forward at float32 (the port's A&S erf differs from exact erf by 1.5e-7)."""
    params = jax_params(name, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 256, 192, 3)).astype(np.float32)
    ref = np.asarray(jax_vitpose_forward(params, jnp.asarray(x), JAX_CASES[name]))
    with torch.no_grad():
        got = vitpose_forward(port_model(params, name), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=1e-4)


def test_head_matches_jax():
    """One F.conv_transpose2d per stage + eval BN + ReLU + final conv vs the
    JAX head's phase lowering, on random BN statistics."""
    cfg = JAX_CASES["tiny"]
    sd, _, _ = load_case("tiny")
    params = convert_vitpose_state_dict(sd, cfg)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 16, 12, 96)).astype(np.float32)
    ref, _ = jhead.head_forward(params["head"], jnp.asarray(feats), cfg.head)
    model = ViTPose(CASES["tiny"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = head_forward(model.keypoint_head,
                           torch.from_numpy(feats).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_from_jax_inverts_the_jax_converter(name):
    """state_dict_from_jax(convert_vitpose_state_dict(sd)) gives sd back, so
    the patch unfold order, the deconv pre-flip and HWIO are undone exactly."""
    sd, _, _ = load_case(name)
    back = state_dict_from_jax(convert_vitpose_state_dict(sd, JAX_CASES[name]), CASES[name])
    want = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_init_params_is_seeded_and_complete():
    cfg = CASES["tiny"]
    a, b, c = init_params(cfg, 7), init_params(cfg, 7), init_params(cfg, 8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.pos_embed"], sc["backbone.pos_embed"])
    # every float parameter is random (kernels see nonzero biases and affines)
    for k, v in sa.items():
        if v.is_floating_point() and v.numel() > 1:
            assert float(v.std()) > 0, k


def test_serving_copies():
    model = init_params(CASES["tiny"], 0)
    b16 = cast_params(model, torch.bfloat16)
    assert compute_dtype(b16) == torch.bfloat16
    bn = b16.keypoint_head.deconv_layers[1]
    assert bn.running_mean.dtype == torch.float32 and bn.running_var.dtype == torch.float32
    assert torch.equal(bn.running_var, model.keypoint_head.deconv_layers[1].running_var)
    assert compute_dtype(model) == torch.float32          # the source is untouched
    q8 = serving_copy(model, "int8")
    assert compute_dtype(q8) == torch.bfloat16
    assert all(isinstance(b, QBlock) for b in q8.backbone.blocks)
    assert q8.backbone.blocks[0].qkv_wq.dtype == torch.int8
    with pytest.raises(ValueError, match="dtype"):
        serving_copy(model, "fp16")
