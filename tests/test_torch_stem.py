"""PyTorch port: the hybrid CNN stem (``models/stem.py``) against the JAX
package's ``models/stem.py``.

A tiny model (D=96, depth 2, 4 heads, a 2-stage stem of 8 and 16
channels) on 64x48 crops, whose /4 grid is PatchEmbed's 16x12, and on
63x47 crops, where JAX's SAME padding splits (1, 1) instead of (0, 1).
The weights are the port's numpy-seeded ``init_params`` (every bias and
norm random), carried to JAX's tree by ``convert/from_jax.py``; the port
runs on the CPU, where its blocks take the kernels' plain versions.
Tolerances, relative to the largest value of each compared tensor:
forwards at float32 1e-5 (conv and matmul sums in another order);
gradients 1e-4 (float32 sums of the 16x12 grid's 192 rows and the head's
maps in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.models.stem import stem_forward as jax_stem_forward
from easy_vitpose_tpu.models.vit import vit_forward as jax_vit_forward
from easy_vitpose_tpu.models.vitpose import vitpose_forward_train
from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu.train.losses import joints_mse_loss as jax_mse
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import state_dict_from_jax, state_dict_to_jax
from easy_vitpose_tpu_torch.models.stem import same_pad, stem_forward
from easy_vitpose_tpu_torch.models.vit import vit_forward
from easy_vitpose_tpu_torch.models.vitpose import ViTPose, init_params
from easy_vitpose_tpu_torch.train import step as pstep
from tests.test_torch_train_optim import masked_adamw  # noqa: F401  (a fixture)

torch.set_num_threads(2)
STEM = (8, 16)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
SIZES = {"even": (64, 48), "odd": (63, 47)}


def jcfg(size):
    return ModelConfig("stemtiny", "coco",
                       BackboneConfig(embed_dim=96, depth=2, num_heads=4, img_size=size,
                                      stem_channels=STEM),
                       HeadConfig(in_channels=96, num_keypoints=17, deconv_filters=(32, 32)))


def pcfg(size):
    return tc.ModelConfig("stemtiny", "coco",
                          tc.BackboneConfig(embed_dim=96, depth=2, num_heads=4, img_size=size,
                                            stem_channels=STEM),
                          tc.HeadConfig(in_channels=96, num_keypoints=17, deconv_filters=(32, 32)))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def params():
    """The stem model's params as JAX's tree (the same for both sizes: the
    grid is 16x12)."""
    p = pcfg(SIZES["even"])
    return state_dict_to_jax(init_params(p, 0).state_dict(), p)


def model_of(params, size):
    m = ViTPose(pcfg(size))
    m.load_state_dict(state_dict_from_jax(params, pcfg(size)))
    return m.eval()


def crops(size, seed=1, n=2):
    return np.random.default_rng(seed).normal(size=(n, *size, 3)).astype(np.float32)


def test_same_pad_is_jax_split():
    """SAME at stride 2: 0 before and 1 after on an even size, 1 and 1 on an
    odd one, which ``padding=1`` gets wrong on the even size."""
    assert same_pad(256) == (0, 1) and same_pad(64) == (0, 1) and same_pad(63) == (1, 1)
    x = torch.randn(1, 1, 8, 8)
    w = torch.randn(1, 1, 3, 3)
    assert not torch.allclose(F.conv2d(F.pad(x, (0, 1, 0, 1)), w, stride=2),
                              F.conv2d(x, w, stride=2, padding=1))


@pytest.mark.parametrize("size", SIZES)
def test_stem_and_backbone_match_jax(params, size):
    """``stem_forward`` and the whole backbone (the stem feeding the blocks:
    the kernels' plain versions, and ``plain=True``) against JAX's."""
    hw = SIZES[size]
    cfg, model = jcfg(hw), model_of(params, hw)
    x = crops(hw)
    want = np.asarray(jax_stem_forward(params["backbone"]["stem"], jnp.asarray(x), cfg.backbone))
    sd = dict(model.state_dict())
    with torch.no_grad():
        got = stem_forward(sd, torch.from_numpy(x), model.cfg.backbone, "backbone.patch_embed")
        assert got.shape == (2, 16 * 12, 96)
        assert rel(got, want) <= FWD_TOL
        want = np.asarray(jax_vit_forward(params["backbone"], jnp.asarray(x), cfg.backbone))
        for plain in (False, True):
            assert rel(vit_forward(model.backbone, torch.from_numpy(x), plain=plain),
                       want) <= FWD_TOL


def test_stem_gradients_match_jax(params):
    """One f32 training forward and backward through the stem (the training
    block's plain versions, and the XLA block) against JAX's
    ``value_and_grad`` of the same loss: the loss and every gradient leaf,
    the stem's included."""
    hw = SIZES["even"]
    cfg, p = jcfg(hw), pcfg(hw)
    rng = np.random.default_rng(2)
    x = crops(hw, seed=3)
    t = rng.uniform(0, 1, (2, 17, 64, 48)).astype(np.float32)
    w = (rng.uniform(size=(2, 17, 1)) > 0.2).astype(np.float32)
    trainable, bn = jstep.split_bn_state(params)

    def loss(tr):
        heat, _ = vitpose_forward_train(jstep.merge_bn_state(tr, bn), jnp.asarray(x), cfg)
        return jax_mse(heat, jnp.asarray(t), jnp.asarray(w))

    lj, gj = jax.jit(jax.value_and_grad(loss))(trainable)
    gj = state_dict_from_jax(jax.tree.map(np.asarray, gj), p, bn_state=False)
    full = state_dict_from_jax(params, p)
    tr_p, bn_p = pstep.split_bn_state(full)
    batch = {"images": torch.from_numpy(x), "targets": torch.from_numpy(t),
             "target_weights": torch.from_numpy(w)}
    stem_leaves = [k for k in gj if k.startswith("backbone.patch_embed.")]
    assert len(stem_leaves) == 4 * len(STEM) + 2
    for impl in ("fused_train", "xla"):
        lp, _, gp = pstep.loss_and_grads(p, tr_p, bn_p, batch, use_amp=False, block_impl=impl)
        assert abs(float(lp) - float(lj)) <= FWD_TOL * abs(float(lj))
        for k in gj:
            assert rel(gp[k], gj[k]) <= GRAD_TOL, (impl, k)
        assert all(float(gp[k].abs().max()) > 0 for k in stem_leaves)


def test_stem_state_dict_round_trip(params):
    """``state_dict_to_jax`` of the port's stem model is JAX's tree, bit for bit."""
    p = pcfg(SIZES["even"])
    tree = params
    back = state_dict_to_jax(state_dict_from_jax(tree, p), p)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_decay_rules_on_stem_leaves(params, masked_adamw):  # noqa: F811
    """``weight_decay_mask`` and ``layerwise_lr_decay`` on the stem leaves
    give JAX's masked AdamW chain's zero-gradient update (-lr * wd * scale
    where a leaf decays): no decay on the stem's biases and norms, the
    stem scaled as layer 0 (rate ** depth)."""
    lr, wd, rate = 1e-3, 0.1, 0.6
    p = pcfg(SIZES["even"])
    tr, _ = jstep.split_bn_state(params)
    ones = jax.tree.map(jnp.ones_like, tr)
    tx = masked_adamw(lr, weight_decay=wd, layer_decay_rate=rate, depth=2)
    new = jax.jit(lambda g, p: jstep.apply_optimizer(tx, g, tx.init(p), p)[0])(
        jax.tree.map(jnp.zeros_like, ones), ones)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, new), p, bn_state=False)
    mask, scale = pstep.weight_decay_mask(p), pstep.layerwise_lr_decay(rate, p)
    stem = [k for k in ref if k.startswith("backbone.patch_embed.")]
    for k in stem:
        want = -lr * wd * scale(k) * mask(k)
        assert float((ref[k] - 1.0 - want).abs().max()) <= 2.0 ** -23, k
        assert scale(k) == pytest.approx(rate ** 2)
    assert {k for k in stem if mask(k)} == {
        "backbone.patch_embed.convs.0.weight", "backbone.patch_embed.convs.1.weight",
        "backbone.patch_embed.proj.weight"}


def test_configs_carry_the_stem():
    """The port's configs give JAX's grid and fields, and ``ViT`` builds the
    stem under ``backbone.patch_embed`` (the Linear as the reference
    HybridEmbed's ``proj``)."""
    from easy_vitpose_tpu.configs import get_model_config as jax_config
    for kw in ({}, {"stem_channels": (64, 128, 256, 512)}, {"simple_head": True}):
        a, b = jax_config("coco", "b", **kw), tc.get_model_config("coco", "b", **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.backbone.patch_shape == b.backbone.patch_shape
    assert jcfg(SIZES["odd"]).backbone.patch_shape == pcfg(SIZES["odd"]).backbone.patch_shape
    with torch.device("meta"):
        m = ViTPose(tc.get_model_config("coco", "b", stem_channels=(64, 128, 256, 512)))
    assert tuple(m.state_dict()["backbone.patch_embed.proj.weight"].shape) == (768, 512)
