"""PyTorch port: the "simple" head (no deconvs, a x4 bilinear upsample, a
3x3 final conv; ``get_model_config(simple_head=True)``) against the JAX
package's ``head_forward``, in serving and in training.

The upsample is ``F.interpolate(bilinear, align_corners=False)`` where JAX
has ``jax.image.resize(..., "bilinear")``: both sample at half-pixel
centres; at the border JAX drops the taps outside the map and renormalises
where torch clamps the source coordinate, which at x4 gives the same taps
with the same weights (0.125, 0.375, 0.625, 0.875, exact in float).  The
measured gap on 16x12 maps is 2 ulps of the largest value (half the
values bit-equal; ``test_upsample_gap`` allows 4), so the bounds are float
rounding: the resize 1e-6
of the largest value, the head and model forwards and the gradients 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.models.head import head_forward as jax_head_forward
from easy_vitpose_tpu.models.vitpose import vitpose_forward as jax_vitpose_forward
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import state_dict_to_jax
from easy_vitpose_tpu_torch.models.head import (head_forward, head_forward_train,
                                                upsample_bilinear)
from easy_vitpose_tpu_torch.models.vitpose import ViTPose, init_params, vitpose_forward

torch.set_num_threads(2)
RESIZE_TOL, TOL = 1e-6, 1e-5
HEAD = dict(in_channels=96, num_keypoints=17, deconv_filters=(), deconv_kernels=(),
            final_conv_kernel=3, upsample=4)
JCFG = ModelConfig("simple", "coco", BackboneConfig(embed_dim=96, depth=2, num_heads=4),
                   HeadConfig(**HEAD))
PCFG = tc.ModelConfig("simple", "coco", tc.BackboneConfig(embed_dim=96, depth=2, num_heads=4),
                      tc.HeadConfig(**HEAD))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def model():
    return init_params(PCFG, 0)


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(1).normal(size=(2, 16, 12, 96)).astype(np.float32)


def test_config_matches_jax():
    for size in "sb":
        from easy_vitpose_tpu.configs import get_model_config
        assert (dataclasses.asdict(get_model_config("coco", size, simple_head=True))
                == dataclasses.asdict(tc.get_model_config("coco", size, simple_head=True)))
    sd = ViTPose(PCFG).state_dict()
    assert [k for k in sd if k.startswith("keypoint_head.")] == [
        "keypoint_head.final_layer.weight", "keypoint_head.final_layer.bias"]


def test_upsample_gap(feats):
    """x4: the interior, the first two and last two output rows and columns."""
    x = np.moveaxis(feats, -1, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(feats), (2, 64, 48, 96), "bilinear"))
    got = upsample_bilinear(torch.from_numpy(x), 4).permute(0, 2, 3, 1).numpy()
    assert rel(got, want) <= RESIZE_TOL
    gap = np.abs(got - want)
    assert gap.max() <= 4 * np.spacing(np.float32(np.abs(want).max()))


def test_serving_head_and_model_match_jax(model, feats):
    tree = state_dict_to_jax(model.state_dict(), PCFG)
    want, _ = jax_head_forward(tree["head"], jnp.asarray(feats), JCFG.head, train=False)
    with torch.no_grad():
        got = head_forward(model.keypoint_head, torch.from_numpy(feats).permute(0, 3, 1, 2))
    assert got.shape == (2, 17, 64, 48)
    assert rel(got.permute(0, 2, 3, 1), want) <= TOL
    x = np.random.default_rng(2).normal(size=(2, 256, 192, 3)).astype(np.float32)
    want = jax_vitpose_forward(tree, jnp.asarray(x), JCFG)
    with torch.no_grad():
        for plain in (False, True):
            assert rel(vitpose_forward(model, torch.from_numpy(x), plain=plain), want) <= TOL


def test_train_head_matches_jax(model, feats):
    """Train mode (no BatchNorm to update): heatmaps and the gradients of
    a loss with respect to the features and both final-conv leaves."""
    tree = state_dict_to_jax(model.state_dict(), PCFG)
    t = np.random.default_rng(3).uniform(size=(2, 64, 48, 17)).astype(np.float32)

    def jloss(head, x):
        heat, bn = jax_head_forward(head, x, JCFG.head, train=True)
        return jnp.mean((heat - t) ** 2), heat

    (lj, hj), (gh, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        tree["head"], jnp.asarray(feats))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state_dict().items() if k.startswith("keypoint_head.")}
    x = torch.from_numpy(feats).requires_grad_(True)
    heat, new_bn = head_forward_train(params, x.permute(0, 3, 1, 2), PCFG.head)
    assert new_bn == {}
    lp = torch.mean((heat.permute(0, 2, 3, 1) - torch.from_numpy(t)) ** 2)
    assert rel(heat.detach().permute(0, 2, 3, 1), hj) <= TOL
    assert abs(float(lp.detach()) - float(lj)) <= TOL * float(lj)
    lp.backward()
    assert rel(x.grad, gx) <= TOL
    assert rel(params["keypoint_head.final_layer.weight"].grad.permute(2, 3, 1, 0),
               gh["final_w"]) <= TOL
    assert rel(params["keypoint_head.final_layer.bias"].grad, gh["final_b"]) <= TOL
