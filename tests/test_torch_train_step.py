"""PyTorch port: the training step and its parts against the JAX package.

The whole step runs at the tiny config of tests/test_fused_block_train.py
(D=96, depth 2, 4 heads, drop-path 0.2, head 32x32) on a device-input batch
of three crops, two steps at float32 and at AMP, with JAX's own drop-path
draws handed to the port; and at a wide config (ViT-L's D=1024, 16 heads,
hidden 4096, drop-path 0.5, depth 1), where the block's backward takes the
wide MLP flavor (K6b, K6c), with int8 Adam moments (K9).  JAX runs its
fused training kernels in interpret mode
(``block_impl="pallas_train_interpret"``); the port runs on the CPU, where
its training block takes the kernels' plain versions.  Every weight is
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


def random_params(seed=0, cfg=CFG):
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        if "bn_state" in jax.tree_util.keystr(path):
            return a
        return a + jnp.asarray(0.02 * rng.standard_normal(a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(noisy, init_vitpose_params(jax.random.PRNGKey(0), cfg))


def port_tree(tree, cfg=PCFG):
    """A JAX trainable tree (params, grads, mu or nu) in the port's names."""
    return state_dict_from_jax(tree, cfg, bn_state=False)


def two_steps(amp, params, batch, keys, masks, **step_kw):
    """JAX's and the port's (state, metrics) before and after each of two
    steps from ``params``, JAX drawing drop-path from ``keys`` and the port
    given ``masks``; ``step_kw`` go to both ``make_train_step``s."""
    tx = jax_fused_adam(LR, max_grad_norm=1.0)
    jf = jax.jit(jstep.make_train_step(CFG, tx, use_amp=amp, block_impl="pallas_train_interpret",
                                       **step_kw))
    js = jstep.init_train_state(params, tx, ema_decay=step_kw.get("ema_decay", 0.0))
    ptx = make_fused_adam(LR, max_grad_norm=1.0)
    pf = pstep.make_train_step(PCFG, ptx, use_amp=amp, **step_kw)
    ps = pstep.init_train_state(state_dict_from_jax(params, PCFG), ptx,
                                ema_decay=step_kw.get("ema_decay", 0.0), device="cpu")
    seq = [(js, None, ps, None)]
    for k, m in zip(keys, masks):
        js, jm = jf(js, {n: jnp.asarray(v) for n, v in batch.items()}, k)
        ps, pm = pf(ps, batch, drop_path_masks=torch.from_numpy(m))
        seq.append((js, jm, ps, pm))
    return seq


def step_keys_and_masks(batch_rows=B):
    keys = [jax.random.PRNGKey(10 + i) for i in range(STEPS)]
    return keys, [np.array(draw_drop_path_masks(k, CFG.backbone, batch_rows)) for k in keys]


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's state and metrics after each of two steps, at
    float32 and AMP."""
    params = random_params()
    batch = raw_batch(np.random.default_rng(1))
    keys, masks = step_keys_and_masks()
    out = {amp: two_steps(amp, params, batch, keys, masks) for amp in (False, True)}
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
    check_amp_steps(runs[True], runs[False])


def check_amp_steps(amp_seq, f32_seq):
    p0 = amp_seq[0][2]["params"]
    for (js, jm, ps, pm), (fs, fm, _, _) in zip(amp_seq[1:], f32_seq[1:]):
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


@pytest.fixture(scope="module")
def flavored_runs():
    """Two AMP steps with ``EVT_TRAIN_ATTN=saved`` and ``EVT_TRAIN_MLP=saved``
    on both sides (set while JAX traces its step and while the port runs),
    from the ``runs`` fixture's params, batch and drop-path draws."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVT_TRAIN_ATTN", "saved")
        mp.setenv("EVT_TRAIN_MLP", "saved")
        mp.delenv("EVT_TRAIN_WIDE", raising=False)
        return two_steps(True, random_params(), raw_batch(np.random.default_rng(1)),
                         *step_keys_and_masks())


def test_flavored_amp_steps_match_jax(flavored_runs, runs):
    """The saved-qkv and saved-m flavors (K7 ``_saved``, K6a ``_ms``) through
    two AMP steps against JAX's step under the same switches: the first
    step's gradients and both steps as the default flavor's AMP steps are
    held (the final bias and the grad norm to JAX's float32 step)."""
    jg, pg = first_grads(flavored_runs)
    fg = first_grads(runs[False])[0]
    for k in pg:
        ref, tol = (fg[k], 2e-2) if k == FINAL_BIAS else (jg[k], 0.1)
        assert rel(pg[k], ref) <= tol, k
    check_amp_steps(flavored_runs, runs[False])


def test_xla_block_step_matches_fused_block_step():
    """The port's two block paths under autograd give the same float32 step:
    the training block (plain K5/K6a/K7) and the XLA block (exact erf, 2e-4
    of each leaf's largest gradient, the bound of
    tests/test_fused_block_train.py)."""
    params = random_params(3)
    batch = pstep.render_batch_on_device(raw_batch(np.random.default_rng(4), 2), device="cpu")
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
    state = pstep.init_train_state(state_dict_from_jax(params, PCFG), tx, device="cpu")
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
    got = pstep.render_batch_on_device(raw, device="cpu")
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


def test_init_train_state_runs_on_cuda_unless_asked():
    """The state goes to CUDA unless the caller asks for the CPU: without a
    CUDA device the default raises, and ``device="cpu"`` keeps it here."""
    model = ViTPose(PCFG)
    tx = make_fused_adam(LR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="runs on CUDA.*device='cpu'"):
            pstep.init_train_state(model, tx)
    state = pstep.init_train_state(model, tx, device="cpu")
    assert state["step"].device.type == "cpu"
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in (*state["params"].values(), *state["bn_state"].values()))
    w = "backbone.blocks.0.attn.qkv.weight"
    assert torch.equal(state["params"][w], model.state_dict()[w])
    assert state["params"][w].data_ptr() != model.state_dict()[w].data_ptr()


def test_render_batch_runs_on_cuda_unless_asked():
    """A numpy batch without a device renders on CUDA: without a CUDA device
    that raises, and ``device="cpu"`` keeps it here, as does a batch of CPU
    tensors (the render runs where its images are)."""
    raw = raw_batch(np.random.default_rng(9), 2)
    if torch.cuda.is_available():
        assert pstep.render_batch_on_device(raw)["images"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="runs on CUDA.*device='cpu'"):
            pstep.render_batch_on_device(raw)
    on_cpu = pstep.render_batch_on_device(raw, device="cpu")
    from_tensors = pstep.render_batch_on_device({k: torch.from_numpy(v) for k, v in raw.items()})
    for k, v in on_cpu.items():
        assert v.device.type == "cpu" and torch.equal(v, from_tensors[k]), k


# ------------------------------- grad accumulation, EMA, loss, eval, render
EMA, ACCUM, AB = 0.9, 2, 4


@pytest.fixture(scope="module")
def accum_runs():
    """Two float32 steps of four crops in two micro-batches with an EMA of
    decay 0.9, on both sides.  JAX splits each step's key in two and draws
    each micro-batch's masks from its half; the port gets those masks, side
    by side along B."""
    keys = [jax.random.PRNGKey(30 + i) for i in range(STEPS)]
    masks = [np.concatenate([np.array(draw_drop_path_masks(kk, CFG.backbone, AB // ACCUM))
                             for kk in jax.random.split(k, ACCUM)], axis=1) for k in keys]
    return two_steps(False, random_params(21), raw_batch(np.random.default_rng(22), AB), keys,
                     masks, ema_decay=EMA, grad_accum=ACCUM)


def test_grad_accum_and_ema_match_jax(accum_runs):
    """``grad_accum=2`` with ``ema_decay=0.9`` at float32 against JAX's step,
    after each step: loss and grad norm to 1e-5, the params to 2% of lr, the
    BN running statistics (chained through both micro-batches) to 1e-6; and
    the EMA's move (each EMA leaf minus its start) to 0.1 of 2% of lr, its
    share of the params' bound, plus two float32 ulps of the EMA (a missing
    update would part them by 0.1 lr)."""
    e0 = accum_runs[0][2]["ema_params"]
    for js, jm, ps, pm in accum_runs[1:]:
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
        jp, je = port_tree(js["params"]), port_tree(js["ema_params"])
        assert set(ps["ema_params"]) == set(ps["params"]) == set(je)
        for k, v in ps["params"].items():
            assert float((v - jp[k]).abs().max()) <= 0.02 * LR, k
            e = ps["ema_params"][k]
            bound = (1 - EMA) * 0.02 * LR + 2 * 2 ** -23 * e.abs()
            assert bool(((e - e0[k]) - (je[k] - e0[k])).abs().le(bound).all()), k
        jbn = jax_bn_state(js)
        for k, v in ps["bn_state"].items():
            assert float((v - jbn[k]).abs().max()) <= 1e-6, k
    assert float((accum_runs[-1][2]["ema_params"][FINAL_BIAS] - e0[FINAL_BIAS]).abs().max()) > 0.1 * LR


def test_grad_accum_needs_a_divisible_batch():
    """A batch that ``grad_accum`` does not divide raises, as JAX asserts."""
    tx = make_fused_adam(LR)
    state = pstep.init_train_state(ViTPose(PCFG), tx, device="cpu")
    step = pstep.make_train_step(PCFG, tx, use_amp=False, grad_accum=2)
    with pytest.raises(ValueError, match="batch 3 not divisible by grad_accum 2"):
        step(state, raw_batch(np.random.default_rng(23), 3), torch.Generator())


def test_loss_fn_is_the_steps_loss():
    """``loss_fn`` is the loss the step reports and differentiates: twice
    the MSE doubles the loss and the (unclipped) grad norm."""
    params = state_dict_from_jax(random_params(24), PCFG)
    batch = raw_batch(np.random.default_rng(25), 2)
    masks = torch.ones((PCFG.backbone.depth, 2, 1, 1))
    out = []
    for fn in (joints_mse_loss, lambda h, t, w: 2.0 * joints_mse_loss(h, t, w)):
        tx = make_fused_adam(LR, max_grad_norm=1e9)
        step = pstep.make_train_step(PCFG, tx, use_amp=False, loss_fn=fn)
        out.append(step(pstep.init_train_state(params, tx, device="cpu"), batch,
                        drop_path_masks=masks)[1])
    assert float(out[1]["loss"]) == 2.0 * float(out[0]["loss"])
    assert abs(float(out[1]["grad_norm"]) - 2.0 * float(out[0]["grad_norm"])) \
        <= 1e-6 * float(out[1]["grad_norm"])


@pytest.mark.parametrize("return_heatmaps", [False, True])
def test_eval_step_matches_jax(accum_runs, return_heatmaps):
    """``make_eval_step`` (the serving forward, eval-mode BN) with a target
    sigma of 2 against JAX's ``make_eval_step`` on the same float32 state:
    the loss to 1e-4, the heatmaps as tests/test_torch_model.py holds the
    forward (1e-5 of their largest value, 1e-4 relative)."""
    from easy_vitpose_tpu_torch.convert.from_jax import train_state_from_jax

    js = accum_runs[-1][0]
    batch = raw_batch(np.random.default_rng(26), 2)
    kw = {"use_amp": False, "return_heatmaps": return_heatmaps, "render_kwargs": {"sigma": 2.0}}
    ref = jstep.make_eval_step(CFG, **kw)(js, {n: jnp.asarray(v) for n, v in batch.items()})
    got = pstep.make_eval_step(PCFG, **kw)(train_state_from_jax(js, PCFG, device="cpu"), batch)
    jl, pl = (ref[0], got[0]) if return_heatmaps else (ref, got)
    assert abs(float(pl) - float(jl)) <= 1e-4 * float(jl)
    if return_heatmaps:
        r = np.asarray(ref[1])
        assert got[1].dtype == torch.float32 and got[1].shape == r.shape
        np.testing.assert_allclose(got[1].numpy(), r, atol=1e-5 * max(1.0, np.abs(r).max()),
                                   rtol=1e-4)


def test_render_kwargs_match_jax():
    """The renderer's options against JAX's: other map and image sizes,
    sigma 2 and per-joint weights (weights exact, targets to 1e-6); and
    ``render_kwargs`` through the batch render (sigma 2)."""
    rng = np.random.default_rng(27)
    raw = raw_batch(rng, 3)
    jw_ = rng.uniform(0.5, 1.5, (17, 1)).astype(np.float32)
    kw = {"heatmap_size": (24, 32), "image_size": (96, 128), "sigma": 2.0,
          "use_different_joints_weight": True}
    jt, jw = generate_gaussian_targets_jnp(jnp.asarray(raw["joints"]) / 2,
                                           jnp.asarray(raw["joints_vis"]),
                                           joints_weight=jnp.asarray(jw_), **kw)
    pt, pw = generate_gaussian_targets(torch.from_numpy(raw["joints"]) / 2,
                                       torch.from_numpy(raw["joints_vis"]),
                                       joints_weight=torch.from_numpy(jw_), **kw)
    assert pt.shape == (3, 17, 32, 24)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    assert np.abs(pt.numpy() - np.asarray(jt)).max() <= 1e-6
    got = pstep.render_batch_on_device(raw, device="cpu", render_kwargs={"sigma": 2.0})
    ref = jstep.render_batch_on_device({k: jnp.asarray(v) for k, v in raw.items()},
                                       {"sigma": 2.0})
    np.testing.assert_array_equal(got["target_weights"].numpy(), np.asarray(ref["target_weights"]))
    assert np.abs(got["targets"].numpy() - np.asarray(ref["targets"])).max() <= 1e-6
    assert not torch.equal(got["targets"], pstep.render_batch_on_device(raw, device="cpu")["targets"])


def test_train_state_from_jax_carries_the_ema(accum_runs):
    """``train_state_from_jax`` carries JAX's whole state after two steps
    across, bit for bit (params, EMA, BN statistics, f32 moments, count,
    step), and the port's step takes it from there."""
    from easy_vitpose_tpu_torch.convert.from_jax import train_state_from_jax

    js = accum_runs[-1][0]
    got = train_state_from_jax(js, PCFG, device="cpu")
    for name in ("params", "ema_params"):
        ref = port_tree(js[name])
        assert set(got[name]) == set(ref)
        assert all(torch.equal(got[name][k], ref[k]) for k in ref), name
    jbn = jax_bn_state(js)
    assert all(torch.equal(got["bn_state"][k], jbn[k]) for k in jbn)
    assert int(got["step"]) == int(js["step"]) == int(got["opt_state"].count) == STEPS
    assert all(torch.equal(got["opt_state"].mu[k], v)
               for k, v in port_tree(js["opt_state"].mu).items())
    tx = make_fused_adam(LR)
    new, m = pstep.make_train_step(PCFG, tx, use_amp=False, ema_decay=EMA)(
        got, raw_batch(np.random.default_rng(28), 2), torch.Generator().manual_seed(0))
    assert int(new["step"]) == STEPS + 1 and torch.isfinite(m["loss"])
    assert not torch.equal(new["ema_params"][FINAL_BIAS], got["ema_params"][FINAL_BIAS])


# ------------------------------------------- the wide config, int8 moments
WCFG = ModelConfig(name="tiny_wide", dataset="coco",
                   backbone=BackboneConfig(embed_dim=1024, depth=1, num_heads=16,
                                           drop_path_rate=0.5),
                   head=HeadConfig(in_channels=1024, num_keypoints=17, deconv_filters=(32, 32)))
WPCFG = tc.ModelConfig("tiny_wide", "coco",
                       tc.BackboneConfig(embed_dim=1024, depth=1, num_heads=16, drop_path_rate=0.5),
                       tc.HeadConfig(in_channels=1024, num_keypoints=17, deconv_filters=(32, 32)))
# the codec's bound on how far the two sides' step-2 updates may part, in
# lr (tests/test_torch_fused_opt_q8.py derives 0.134)
CODEC_LR = 0.15


@pytest.fixture(scope="module")
def int8_runs():
    """JAX's and the port's state after each of two steps with int8 moments
    at the wide config, at float32 and AMP; and which JAX leaf each port
    leaf comes from."""
    params = random_params(11, WCFG)
    batch = raw_batch(np.random.default_rng(12))
    keys = [jax.random.PRNGKey(20 + i) for i in range(STEPS)]
    masks = [np.array(draw_drop_path_masks(k, WCFG.backbone, B)) for k in keys]
    out = {}
    for amp in (False, True):
        tx = jax_fused_adam(LR, max_grad_norm=1.0, moment_dtype="int8")
        jf = jax.jit(jstep.make_train_step(WCFG, tx, use_amp=amp,
                                           block_impl="pallas_train_interpret"))
        js = jstep.init_train_state(params, tx)
        ptx = make_fused_adam(LR, max_grad_norm=1.0, moment_dtype="int8")
        pf = pstep.make_train_step(WPCFG, ptx, use_amp=amp)
        ps = pstep.init_train_state(state_dict_from_jax(params, WPCFG), ptx, device="cpu")
        seq = [(js, ps)]
        for k, m in zip(keys, masks):
            js, _ = jf(js, {n: jnp.asarray(v) for n, v in batch.items()}, k)
            ps, _ = pf(ps, batch, drop_path_masks=torch.from_numpy(m))
            seq.append((js, ps))
        out[amp] = seq
    # one block's rate is linspace(0, 0.5, depth)[0] = 0: the drop-path of the
    # wide flavor is held in tests/test_torch_train_block_wide.py
    assert all(np.all(m == 1.0) for m in masks)
    trainable, _ = jstep.split_bn_state(params)
    flat, treedef = jax.tree_util.tree_flatten(trainable)
    marks = port_tree(jax.tree_util.tree_unflatten(
        treedef, [np.full(a.shape, i, np.float32) for i, a in enumerate(flat)]), WPCFG)
    out["leaf_of"] = {k: int(v.reshape(-1)[0]) for k, v in marks.items()}
    return out


def jax_codes(js, moment, part, i):
    return np.asarray(jax.tree_util.tree_leaves(getattr(js["opt_state"], moment)[part])[i])


@pytest.mark.parametrize("amp", [False, True])
def test_two_int8_steps_match_jax(int8_runs, amp):
    """Two steps with int8 moments at the wide config against JAX's step
    (``make_fused_adam(moment_dtype="int8")``, Pallas interpret blocks).

    * Step 1 does not depend on the moments' blocks (the update uses mu' and
      nu' before they are coded, from zero moments): the params within the
      float32-moment tests' tolerances; float32 2% of lr; AMP at most 5% of
      each leaf's weights off by more than lr (10% for the final bias, held
      to JAX's float32 step, ROADMAP C6) and the updates within 0.3 in
      relative L2.
    * Step 2 adds the codec.  The 1-D leaves code the same flat order as
      JAX's at depth 1 and so fall into the same blocks: at float32 their
      codes agree within one level (a share of at most 1e-3 flip across a
      rounding boundary, where the grads differ in their last digits) and
      their scales to 1e-4.  The 2-D weights fall into other blocks
      (ROADMAP.md queue C 9): at float32 their params agree within
      (0.02 + 0.15) lr, all but a share of 1e-3 (elements under the codec's
      1e-6 cutoff on one side only, bounded by 2.2 lr); at AMP the AMP
      criteria hold with the threshold raised by the same 0.15 lr."""
    seq, leaf_of = int8_runs[amp], int8_runs["leaf_of"]
    p0 = seq[0][1]["params"]
    for step, (js, ps) in enumerate(seq[1:], 1):
        jp = port_tree(js["params"], WPCFG)
        fp = port_tree(int8_runs[False][step][0]["params"], WPCFG)
        extra = 0.0 if step == 1 else CODEC_LR
        num = den = 0.0
        for k, v in ps["params"].items():
            d = (v - jp[k]).abs()
            if not amp:
                wide = v.dim() >= 2 and k != "backbone.pos_embed"
                if wide and step == 2:
                    assert float(d.max()) <= 2.2 * LR, k
                    assert float((d > (0.02 + extra) * LR).float().mean()) <= 1e-3, k
                else:
                    assert float(d.max()) <= 0.02 * LR, (step, k)
                continue
            ref = (fp if k == FINAL_BIAS else jp)[k] - p0[k]
            dd = v - p0[k] - ref
            share = float((dd.abs() > (1 + extra) * LR).float().mean())
            assert share <= (0.1 if k == FINAL_BIAS else 0.05), (step, k, share)
            num, den = num + float(dd.square().sum()), den + float(ref.square().sum())
        if amp:
            assert (num / den) ** 0.5 <= 0.3
        if amp or step == 1:
            continue
        flips = total = 0
        for k, v in ps["params"].items():
            if v.dim() != 1:
                continue
            for moment in ("mu", "nu"):
                got = getattr(ps["opt_state"], moment)
                jq = jax_codes(js, moment, "q_tree", leaf_of[k])
                js_ = jax_codes(js, moment, "s_tree", leaf_of[k])
                gq = got["q_tree"][k].numpy().astype(np.int32)
                dq = np.abs(gq - jq.astype(np.int32))
                assert dq.max() <= 1 and gq.shape == jq.shape, (k, moment)
                flips, total = flips + int((dq > 0).sum()), total + v.numel()
                gs = got["s_tree"][k].numpy()
                assert gs.shape == js_.shape and np.all(np.abs(gs - js_) <= 1e-4 * js_), (k, moment)
        assert total > 10000 and flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16", "int8"])
def test_opt_state_from_jax(moment_dtype):
    """``opt_state_from_jax`` carries JAX's fused-Adam state across after two
    updates: count and learning rate; f32 and bf16 moments bit for bit;
    int8 moments decoded, mapped and coded in the port's blocks (depth 2:
    JAX codes both layers' LN leaves in one block, the port each apart), so
    every value lies within half a level of JAX's (within one code level),
    or is 0 where it is under 1e-6 of its new block's absmax.  The port's
    optimizer then takes the state."""
    from easy_vitpose_tpu.train.fused_opt import _q8_decode
    from easy_vitpose_tpu_torch.convert.from_jax import opt_state_from_jax
    from easy_vitpose_tpu_torch.train.fused_opt import Q8_LN_EPS, q8_decode

    trainable, _ = jstep.split_bn_state(random_params(13))
    rng = np.random.default_rng(14)
    tx = jax_fused_adam(LR, moment_dtype=moment_dtype)
    st, apply = tx.init(trainable), jax.jit(tx.fused_apply)
    for _ in range(2):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 1e-3,
                                                   jnp.float32), trainable)
        _, st, _ = apply(grads, st, trainable)
    got = opt_state_from_jax(st, trainable, PCFG)
    assert int(got.count) == 2 and float(got.hyperparams["learning_rate"]) == np.float32(LR)
    for name, levels in (("mu", 127), ("nu", 255)):
        jm, pm = getattr(st, name), getattr(got, name)
        if moment_dtype != "int8":
            ref = port_tree(jm)
            assert set(pm) == set(ref)
            for k, v in pm.items():
                assert v.dtype == (torch.bfloat16 if moment_dtype == "bf16" else torch.float32)
                assert torch.equal(v.float(), ref[k]), k
            continue
        ref = port_tree(jax.tree.map(lambda q, s, p: _q8_decode(q, s, levels, p.shape),
                                     jm["q_tree"], jm["s_tree"], trainable))
        half = -Q8_LN_EPS / (levels - 1) / 2
        for k, r in ref.items():
            r = r.numpy().astype(np.float64)
            v = q8_decode(pm["q_tree"][k], pm["s_tree"][k], levels, r.shape).numpy()
            amax = np.repeat(pm["s_tree"][k].numpy()[:, 0], 2048)[:r.size].reshape(r.shape)
            both = (v != 0) & (r != 0)
            assert np.all(np.abs(np.log(v[both] / r[both])) <= half * (1 + 1e-4)), k
            assert np.all((v != 0) | (np.abs(r) < 1e-6 * amax)), k
            assert np.all((r != 0) | (v == 0)), k
    ptx = make_fused_adam(LR, moment_dtype=moment_dtype)
    pp = port_tree(trainable)
    new, st2, _ = ptx.fused_apply({k: torch.full_like(v, 1e-3) for k, v in pp.items()}, got, pp)
    assert int(st2.count) == 3 and all(torch.isfinite(v).all() for v in new.values())
