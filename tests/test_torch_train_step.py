"""PyTorch port: the training step and its parts against the JAX package.

The whole step runs at the tiny config of tests/test_fused_block_train.py
(D=96, depth 2, 4 heads, drop-path 0.2, head 32x32) on a device-input batch
of three crops, two steps at float32 and at AMP, with JAX's own drop-path
draws handed to the port.  JAX runs its fused training kernels in interpret
mode (``block_impl="pallas_train_interpret"``); the port runs on the CPU,
where its training block takes the kernels' plain versions.  Every weight is
random (the init plus noise), so every gradient term counts.

AMP has one place where the two frameworks reduce differently: XLA on the
CPU sums the final conv's bias gradient over the 64x48 maps in bf16, which
moves it by up to 40% from its float32 value, while torch sums bf16 in
float32.  That one leaf, and the grad norm it feeds, are held to the JAX
float32 step instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.models import head as jhead
from easy_vitpose_tpu.models.vit import draw_drop_path_masks
from easy_vitpose_tpu.models.vitpose import init_vitpose_params
from easy_vitpose_tpu.ops.heatmap import generate_gaussian_targets_jnp
from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu.train.fused_opt import make_fused_adam as jax_fused_adam
from easy_vitpose_tpu.train.losses import joints_mse_loss as jax_mse
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import state_dict_from_jax
from easy_vitpose_tpu_torch.models.head import batch_norm_train
from easy_vitpose_tpu_torch.models.vitpose import ViTPose
from easy_vitpose_tpu_torch.ops.heatmap import generate_gaussian_targets
from easy_vitpose_tpu_torch.train import step as pstep
from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam
from easy_vitpose_tpu_torch.train.losses import joints_mse_loss

torch.set_num_threads(2)
LR, B, STEPS = 3.75e-4, 3, 2
FINAL_BIAS = "keypoint_head.final_layer.bias"
CFG = ModelConfig(name="tiny", dataset="coco",
                  backbone=BackboneConfig(embed_dim=96, depth=2, num_heads=4, drop_path_rate=0.2),
                  head=HeadConfig(in_channels=96, num_keypoints=17, deconv_filters=(32, 32)))
PCFG = tc.ModelConfig("tiny", "coco",
                      tc.BackboneConfig(embed_dim=96, depth=2, num_heads=4, drop_path_rate=0.2),
                      tc.HeadConfig(in_channels=96, num_keypoints=17, deconv_filters=(32, 32)))


def raw_batch(rng, n=B):
    """uint8 crops and joints; some joints invisible, some off the map."""
    return {"images_u8": rng.integers(0, 256, (n, 256, 192, 3), dtype=np.uint8),
            "joints": rng.uniform(-40, 230, (n, 17, 2)).astype(np.float32),
            "joints_vis": (rng.uniform(0, 1, (n, 17, 2)) > 0.2).astype(np.float32)}


def random_params(seed=0):
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        if "bn_state" in jax.tree_util.keystr(path):
            return a
        return a + jnp.asarray(0.02 * rng.standard_normal(a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(noisy, init_vitpose_params(jax.random.PRNGKey(0), CFG))


def port_tree(tree):
    """A JAX trainable tree (params, grads, mu or nu) in the port's names."""
    return state_dict_from_jax(tree, PCFG, bn_state=False)


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's state and metrics after each of two steps, at
    float32 and AMP."""
    params = random_params()
    batch = raw_batch(np.random.default_rng(1))
    keys = [jax.random.PRNGKey(10 + i) for i in range(STEPS)]
    masks = [np.array(draw_drop_path_masks(k, CFG.backbone, B)) for k in keys]
    out = {}
    for amp in (False, True):
        tx = jax_fused_adam(LR, max_grad_norm=1.0)
        jf = jax.jit(jstep.make_train_step(CFG, tx, use_amp=amp,
                                           block_impl="pallas_train_interpret"))
        js = jstep.init_train_state(params, tx)
        ptx = make_fused_adam(LR, max_grad_norm=1.0)
        pf = pstep.make_train_step(PCFG, ptx, use_amp=amp)
        ps = pstep.init_train_state(state_dict_from_jax(params, PCFG), ptx)
        seq = [(js, None, ps, None)]
        for k, m in zip(keys, masks):
            js, jm = jf(js, {n: jnp.asarray(v) for n, v in batch.items()}, k)
            ps, pm = pf(ps, batch, drop_path_masks=torch.from_numpy(m))
            seq.append((js, jm, ps, pm))
        out[amp] = seq
    assert masks[0].min() == 0.0 and masks[0].max() > 1.0     # a dropped and a kept crop
    return out


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def first_grads(seq):
    """The first step's gradients from its first Adam moment, mu = 0.1 s g,
    with each side's own clip scale s = min(1, 1 / grad norm)."""
    js, jm, ps, pm = seq[1]
    js_ = 0.1 * min(1.0, 1.0 / float(jm["grad_norm"]))
    ps_ = 0.1 * min(1.0, 1.0 / float(pm["grad_norm"]))
    jg = {k: v.numpy() / js_ for k, v in port_tree(js["opt_state"].mu).items()}
    pg = {k: v.numpy() / ps_ for k, v in ps["opt_state"].mu.items()}
    return jg, pg


@pytest.mark.parametrize("amp", [False, True])
def test_first_step_grads_match_jax(runs, amp):
    """Every gradient leaf of the first step.  float32: the same math with
    sums in another order, 1e-4 of each leaf's largest value (measured
    6e-6).  AMP: bf16 roundings flip in another order through two blocks
    and the head, 0.1 (measured 0.05); the final bias against JAX's float32
    step at 2e-2 (measured 6e-3)."""
    jg, pg = first_grads(runs[amp])
    assert set(jg) == set(pg) and len(pg) == 2 * 12 + 5 + 8
    for k in pg:
        ref = first_grads(runs[False])[0][k] if amp and k == FINAL_BIAS else jg[k]
        tol = 1e-4 if not amp else (2e-2 if k == FINAL_BIAS else 0.1)
        assert rel(pg[k], ref) <= tol, k


def test_two_steps_f32_match_jax(runs):
    """float32, after each step: loss and grad norm to 1e-5, the moments to
    1e-4 of each leaf's largest value, the BN running statistics to 1e-6,
    and the params to 2% of the learning rate (Adam moves a weight by about
    lr per step, and a gradient near its epsilon moves it most; measured
    0.5%)."""
    for js, jm, ps, pm in runs[False][1:]:
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
        jp = port_tree(js["params"])
        for k, v in ps["params"].items():
            assert float((v - jp[k]).abs().max()) <= 0.02 * LR, k
        for name in ("mu", "nu"):
            jt = port_tree(getattr(js["opt_state"], name))
            for k, v in getattr(ps["opt_state"], name).items():
                assert rel(v.numpy(), jt[k].numpy()) <= 1e-4, (name, k)
        jbn = jax_bn_state(js)
        for k, v in ps["bn_state"].items():
            assert float((v - jbn[k]).abs().max()) <= 1e-6, k
        assert int(ps["step"]) == int(js["step"]) and int(ps["opt_state"].count) == int(js["step"])


def jax_bn_state(js):
    sd = state_dict_from_jax({"backbone": js["params"]["backbone"],
                              "head": {**js["params"]["head"], "bn_state": js["bn_state"]}}, PCFG)
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_two_steps_amp_match_jax(runs):
    """AMP (bf16 forward and backward, float32 masters and Adam), after each
    step: the loss to 1e-4; the grad norm to 2e-2 of JAX's float32 step
    (measured 5e-3); the BN running statistics to 1e-2 of their largest
    value (the mean of bf16 conv outputs; measured 4e-3).  The updates (params minus the initial ones): Adam moves a weight
    by about lr per step whatever the size of its gradient, so a gradient
    within bf16 noise of 0 may move it lr either way.  So at most 5% of each
    leaf's weights may differ by more than lr (measured 3%; 10% and 6% for
    the final bias, held to JAX's float32 step), and all the updates
    together agree to 0.3 in relative L2 (measured 0.18 and 0.13)."""
    p0 = runs[True][0][2]["params"]
    for (js, jm, ps, pm), (fs, fm, _, _) in zip(runs[True][1:], runs[False][1:]):
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
        assert abs(float(pm["grad_norm"]) - float(fm["grad_norm"])) <= 2e-2 * float(fm["grad_norm"])
        jp, fp = port_tree(js["params"]), port_tree(fs["params"])
        num = den = 0.0
        for k, v in ps["params"].items():
            ref = (fp if k == FINAL_BIAS else jp)[k] - p0[k]
            d = v - p0[k] - ref
            assert float((d.abs() > LR).float().mean()) <= (0.1 if k == FINAL_BIAS else 0.05), k
            num, den = num + float(d.square().sum()), den + float(ref.square().sum())
        assert (num / den) ** 0.5 <= 0.3
        jbn = jax_bn_state(js)
        for k, v in ps["bn_state"].items():
            assert rel(v.numpy(), jbn[k].numpy()) <= 1e-2, k


def test_xla_block_step_matches_fused_block_step():
    """The port's two block paths under autograd give the same float32 step:
    the training block (plain K5/K6a/K7) and the XLA block (exact erf, 2e-4
    of each leaf's largest gradient, the bound of
    tests/test_fused_block_train.py)."""
    params = random_params(3)
    batch = pstep.render_batch_on_device(raw_batch(np.random.default_rng(4), 2))
    trainable, bn = pstep.split_bn_state(state_dict_from_jax(params, PCFG))
    masks = torch.tensor([[1.0, 1.25], [0.0, 1.25]]).reshape(2, 2, 1, 1)
    res = [pstep.loss_and_grads(PCFG, trainable, bn, batch, use_amp=False, block_impl=impl,
                                drop_path_masks=masks) for impl in ("fused_train", "xla")]
    assert abs(float(res[0][0]) - float(res[1][0])) <= 1e-5 * float(res[1][0])
    for k in trainable:
        assert rel(res[0][2][k].numpy(), res[1][2][k].numpy()) <= 2e-4, k


def test_step_draws_drop_path_from_a_generator():
    """Without pre-drawn masks the step draws them from the generator: the
    same seed gives the same step, another seed another one."""
    params = random_params(5)
    tx = make_fused_adam(LR)
    step = pstep.make_train_step(PCFG, tx, use_amp=False)
    batch = raw_batch(np.random.default_rng(6), 4)
    state = pstep.init_train_state(state_dict_from_jax(params, PCFG), tx)
    losses = [float(step(state, batch, torch.Generator().manual_seed(s))[1]["loss"])
              for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="Generator"):
        step(state, batch)


def test_targets_and_loss_match_jax():
    """The device-input render (targets, weights, normalized images) is the
    JAX render: weights exact (trunc, out-of-bounds, visibility), targets to
    1e-6 (exp in another library), images to 1e-6; the loss to 1e-6."""
    rng = np.random.default_rng(7)
    raw = raw_batch(rng, 4)
    raw["joints"][0, :4] = [[-30.0, 10.0], [400.0, 50.0], [-2.3, -2.6], [191.5, 255.5]]
    got = pstep.render_batch_on_device(raw)
    jt, jw = generate_gaussian_targets_jnp(jnp.asarray(raw["joints"]), jnp.asarray(raw["joints_vis"]))
    ref = jstep.render_batch_on_device({k: jnp.asarray(v) for k, v in raw.items()})
    np.testing.assert_array_equal(got["target_weights"].numpy(), np.asarray(jw))
    assert np.abs(got["targets"].numpy() - np.asarray(jt)).max() <= 1e-6
    assert np.abs(got["images"].numpy() - np.asarray(ref["images"])).max() <= 1e-6
    pt, pw = generate_gaussian_targets(torch.from_numpy(raw["joints"]),
                                       torch.from_numpy(raw["joints_vis"]))
    assert torch.equal(pt, got["targets"]) and torch.equal(pw, got["target_weights"])
    pred = rng.uniform(0, 1, (4, 17, 64, 48)).astype(np.float32)
    jl = float(jax_mse(jnp.asarray(pred), jt, jw))
    assert abs(float(joints_mse_loss(torch.from_numpy(pred), pt, pw)) - jl) <= 1e-6 * jl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(dtype):
    """Train-mode BN: output to 1e-6 (float32) or one bf16 rounding, and the
    new running statistics (biased variance to normalize, unbiased in the
    average, momentum 0.1) to 1e-6 of their largest value."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 8, 6, 5)) * 2 + 0.5).astype(np.float32)
    p = {k: rng.uniform(0.5, 1.5, 8).astype(np.float32) for k in ("scale", "bias", "mean", "var")}
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1), jdt)
    y, st = jhead.batch_norm(xj, {k: jnp.asarray(v, jdt if k in ("scale", "bias") else jnp.float32)
                                  for k, v in p.items()}, train=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    tdt = getattr(torch, dtype)
    got, mean, var = batch_norm_train(torch.from_numpy(x).to(tdt), t["scale"].to(tdt),
                                      t["bias"].to(tdt), t["mean"], t["var"])
    ref = np.asarray(y, np.float32).transpose(0, 3, 1, 2)
    assert rel(got.float().numpy(), ref) <= (1e-6 if dtype == "float32" else 2 ** -8)
    assert rel(mean.numpy(), np.asarray(st["mean"])) <= 1e-6
    assert rel(var.numpy(), np.asarray(st["var"])) <= 1e-6


def test_from_jax_maps_trainable_trees():
    """``state_dict_from_jax(..., bn_state=False)`` maps the trainable tree,
    and so grads and moments, to the port's trainable names; round trip:
    the port's weights through the JAX package's own converter and its
    ``split_bn_state`` come back bit for bit."""
    from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict

    model = ViTPose(PCFG)
    trainable, bn = pstep.split_bn_state(model.state_dict())
    gen = torch.Generator().manual_seed(0)
    trainable = {k: torch.randn(v.shape, generator=gen) for k, v in trainable.items()}
    sd = {k: v.numpy() for k, v in {**trainable, **bn}.items()}
    jtree, _ = jstep.split_bn_state(convert_vitpose_state_dict(sd, CFG))
    back = port_tree(jtree)
    assert set(back) == set(trainable)
    for k, v in trainable.items():
        assert torch.equal(back[k], v), k
    full = state_dict_from_jax(random_params(), PCFG)
    assert set(full) == set(trainable) | set(bn)
