"""PyTorch port: the live ViTPose+ model (``models/moe.py``) and its
task-alternating training step (``train/moe_step.py``) against the JAX
package's ``models/moe.py`` and ``train/moe_step.py``.

The sizes of tests/test_moe.py: D=96, depth 2, 4 heads, hidden 384, an fc2
of 64 shared rows and 3 experts of 32 (coco, aic, mpii; heads of 17, 14 and
16 keypoints).  The weights are the port's numpy-seeded
``init_vitpose_plus_params`` (every bias and norm random), carried to JAX's
tree by ``plus_state_dict_to_jax``, which is held to JAX's own converter.
The port runs on the CPU, where its blocks take the kernels' plain
versions (the A&S erf) and ``plain=True`` or ``block_impl="xla"`` JAX's XLA
block (the exact erf).

Tolerances: forwards at float32 within 1e-5 of the largest value; a step's
loss within 1e-5 and its parameters within 2e-5 (absolute), JAX's own
bound between its XLA and Pallas MoE steps (tests/test_moe.py:353-356),
each step from a common state, except where a weight's gradients so far have an RMS under 100 Adam eps
(1e-6): there Adam's ``g / (|g| + eps)`` magnifies the float noise of a
gradient that cancels to ~1e-9 (measured: a coco deconv weight with
gradient 4.9e-9 here and 5.4e-9 in JAX moves 2.05e-5 apart), and those
elements are held within one step's size, the learning rate.  Frozen
leaves are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.convert.vitpose_plus import convert_vitpose_plus_state_dict as jconvert
from easy_vitpose_tpu.models.moe import vitpose_plus_forward as jax_plus_forward
from easy_vitpose_tpu.train import moe_step as jmoe
from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu.train.fused_opt import make_fused_adam as jax_fused_adam
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import (moe_train_state_from_jax,
                                                     plus_state_dict_from_jax,
                                                     plus_state_dict_to_jax)
from easy_vitpose_tpu_torch.models import moe
from easy_vitpose_tpu_torch.train import moe_step as pmoe
from easy_vitpose_tpu_torch.train import step as pstep
from easy_vitpose_tpu_torch.train.fused_opt import FusedAdamState, make_fused_adam

torch.set_num_threads(2)
D, DEPTH, HEADS = 96, 2, 4
TASKS = ("coco", "aic", "mpii")
TASK_K = {"coco": 17, "aic": 14, "mpii": 16}
LR, FWD_TOL, LOSS_TOL, PARAM_TOL = 1e-3, 1e-5, 1e-5, 2e-5
JCFG = ModelConfig("moetiny", "coco", BackboneConfig(embed_dim=D, depth=DEPTH, num_heads=HEADS),
                   HeadConfig(in_channels=D, num_keypoints=17, deconv_filters=(32, 32)))
PCFG = tc.ModelConfig("moetiny", "coco",
                      tc.BackboneConfig(embed_dim=D, depth=DEPTH, num_heads=HEADS),
                      tc.HeadConfig(in_channels=D, num_keypoints=17, deconv_filters=(32, 32)))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def plus():
    """(the port's mapping, JAX's tree) of one random ViTPose+ model."""
    sd = moe.init_vitpose_plus_params(PCFG, 0, TASKS, expert_frac=0.34)
    return sd, plus_state_dict_to_jax(sd, PCFG)


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(1).normal(size=(2, 256, 192, 3)).astype(np.float32)


def batch(rng, task, n=2):
    k = TASK_K[task]
    return {"images": rng.normal(size=(n, 256, 192, 3)).astype(np.float32),
            "targets": rng.uniform(0, 1, (n, k, 64, 48)).astype(np.float32),
            "target_weights": (rng.uniform(size=(n, k, 1)) > 0.1).astype(np.float32)}


def test_layout_and_round_trip(plus):
    """The port's mapping has the reference checkpoint's names and split
    (64 shared + 3 x 32 rows); JAX's converter makes the same tree from it
    as ``plus_state_dict_to_jax``, and the two maps are inverse bit for bit."""
    sd, tree = plus
    assert sd["backbone.blocks.1.mlp.fc2.weight"].shape == (64, 384)
    assert sd["backbone.blocks.1.mlp.experts.2.weight"].shape == (32, 384)
    assert sd["associate_keypoint_heads.1.final_layer.weight"].shape[0] == 16
    assert moe.plus_tasks(sd) == list(TASKS) and moe.num_experts(sd) == 3
    ref = jconvert({k: v.numpy() for k, v in sd.items()}, JCFG)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = plus_state_dict_from_jax(tree, PCFG)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("task", TASKS)
def test_task_forward_matches_jax(plus, crops, task):
    """Per task: the spliced blocks (the block kernel's plain version here)
    and ``plain=True`` (JAX's ``moe_block``) against JAX's live forward."""
    sd, tree = plus
    want = np.asarray(jax_plus_forward(tree, jnp.asarray(crops), JCFG, task))
    assert want.shape == (2, TASK_K[task], 64, 48)
    with torch.no_grad():
        for plain in (False, True):
            got = moe.vitpose_plus_forward(sd, torch.from_numpy(crops), PCFG, task, plain=plain)
            assert rel(got, want) <= FWD_TOL, plain


def test_mixed_batch_matches_jax(plus, crops):
    """A mixed batch (per-sample expert weights, the float32 mix) through
    the coco head against JAX's; each one-hot row's features equal the
    homogeneous forward of its expert."""
    sd, tree = plus
    onehot = np.array([[1, 0, 0], [0, 0, 1]], np.float32)       # coco, mpii
    want = np.asarray(jax_plus_forward(tree, jnp.asarray(crops), JCFG, "coco",
                                       expert_onehot=jnp.asarray(onehot)))
    x = torch.from_numpy(crops)
    with torch.no_grad():
        got = moe.vitpose_plus_forward(sd, x, PCFG, "coco", expert_onehot=torch.from_numpy(onehot))
        assert rel(got, want) <= FWD_TOL
        mixed = moe.vit_plus_forward(sd, x, PCFG, expert_onehot=torch.from_numpy(onehot))
        for row, expert in ((0, 0), (1, 2)):
            homo = moe.vit_plus_forward(sd, x[row:row + 1], PCFG, expert_idx=expert, plain=True)
            assert rel(mixed[row:row + 1], homo) <= FWD_TOL, row


@pytest.fixture(scope="module")
def jax_steps(plus):
    """JAX's state before, after a warm coco step and after an aic step
    (``make_optimizer``, float32, the XLA block), with the batches."""
    _, tree = plus
    rng = np.random.default_rng(4)
    batches = {"coco": batch(rng, "coco"), "aic": batch(rng, "aic")}
    tx = jstep.make_optimizer(LR)
    states = [jmoe.init_moe_train_state(tree, tx)]
    metrics = []
    for task in ("coco", "aic"):
        f = jax.jit(jmoe.make_moe_train_step(JCFG, tx, task, use_amp=False))
        s, m = f(states[-1], {k: jnp.asarray(v) for k, v in batches[task].items()},
                 jax.random.PRNGKey(0))
        states.append(jax.tree.map(np.asarray, s))
        metrics.append(float(m["loss"]))
    return batches, states, metrics


def port_params(state):
    return plus_state_dict_from_jax(state["params"], PCFG, bn_state=False)


def assert_params_close(state, want):
    """``state``'s params against ``want`` (see the module docstring: the
    elements whose gradient RMS, from ``state``'s second moment, is under
    1e-6 are held within the learning rate)."""
    opt = state["opt_state"]
    c2 = 1.0 - 0.999 ** int(opt.count)
    for k, v in want.items():
        d = (state["params"][k] - v).abs()
        flat = (opt.nu[k] / c2).sqrt() < 1e-6
        assert float(torch.where(flat, 0.0, d).max()) <= PARAM_TOL, k
        assert float(torch.where(flat, d, 0.0).max()) <= LR, k


def inactive(names, task):
    return [k for k in names if not pmoe.is_active(k, task)]


def moment_leaves(opt, names):
    """Each named leaf's moments as tensors (f32 leaves, or int8 codes and
    scales)."""
    out = {}
    for part in ("mu", "nu"):
        tree = getattr(opt, part)
        for k in names:
            if "q_tree" in tree:
                out[(part, "q", k)] = tree["q_tree"][k]
                out[(part, "s", k)] = tree["s_tree"][k]
            else:
                out[(part, k)] = tree[k]
    return out


def run_port(sd, tx, batches, block_impl="pallas_train"):
    """The port's state before, after the coco step and after the aic step."""
    states = [pmoe.init_moe_train_state(sd, tx, device="cpu")]
    losses = []
    for task in ("coco", "aic"):
        f = pmoe.make_moe_train_step(PCFG, tx, task, use_amp=False, block_impl=block_impl)
        s, m = f(states[-1], batches[task])
        states.append(s)
        losses.append(float(m["loss"]))
    return states, losses


def assert_aic_step_freezes(before, after):
    """The aic step left the coco and mpii experts and heads, and their
    moments, bit for bit; the aic expert and head, and the shared leaves,
    moved."""
    names = list(before["params"])
    frozen = inactive(names, "aic")
    assert len(frozen) == 2 * DEPTH * 2 + 2 * 8        # 2 experts x 2 blocks x w, b; 2 heads
    for k in frozen:
        assert torch.equal(after["params"][k], before["params"][k]), k
    mb, ma = moment_leaves(before["opt_state"], frozen), moment_leaves(after["opt_state"], frozen)
    for key in mb:
        assert torch.equal(ma[key], mb[key]), key
    for k in ("backbone.blocks.0.mlp.experts.1.weight", "backbone.blocks.0.mlp.fc2.weight",
              "associate_keypoint_heads.0.final_layer.weight", "backbone.pos_embed"):
        assert float((after["params"][k] - before["params"][k]).abs().max()) > 0, k
    assert int(after["opt_state"].count) == int(before["opt_state"].count) + 1


def from_jax_warm(jstate, fused: bool = False):
    """JAX's state as the port's (``moe_train_state_from_jax``), its Adam
    state as ``make_fused_adam``'s when ``fused``."""
    state = moe_train_state_from_jax(jstate, PCFG, device="cpu")
    if fused:
        state["opt_state"] = FusedAdamState(*state["opt_state"])
    return state


@pytest.mark.parametrize("block_impl", ["pallas_train", "xla"])
def test_moe_step_matches_jax(plus, jax_steps, block_impl):
    """The port's step with ``make_optimizer`` at float32: the coco step
    from the same weights against JAX's (loss, parameters), then the aic
    step from JAX's warm state (``moe_train_state_from_jax``: the same
    weights and moments; two trajectories of Adam drift apart by up to a
    step's size where a gradient is near zero, so each step is held from a
    common state), which freezes the other tasks bit for bit."""
    sd, _ = plus
    batches, jstates, jlosses = jax_steps
    tx = pstep.make_optimizer(LR)
    states, losses = run_port(sd, tx, batches, block_impl)
    assert abs(losses[0] - jlosses[0]) <= LOSS_TOL * abs(jlosses[0])
    assert_params_close(states[1], port_params(jstates[1]))
    assert_aic_step_freezes(states[1], states[2])
    warm = from_jax_warm(jstates[1])
    assert int(warm["opt_state"].count) == 1 and int(warm["step"]) == 1
    s, m = pmoe.make_moe_train_step(PCFG, tx, "aic", use_amp=False,
                                    block_impl=block_impl)(warm, batches["aic"])
    assert abs(float(m["loss"]) - jlosses[1]) <= LOSS_TOL * abs(jlosses[1])
    assert_params_close(s, port_params(jstates[2]))
    assert_aic_step_freezes(warm, s)


def test_fused_adam_f32_step_matches_jax(plus, jax_steps):
    """The same with ``make_fused_adam``'s float32 moments (which JAX's
    step cannot take, C16) against JAX's optax Adam steps: Adam's
    arithmetic is the same, so the same bounds hold."""
    sd, _ = plus
    batches, jstates, jlosses = jax_steps
    tx = make_fused_adam(LR)
    states, losses = run_port(sd, tx, batches)
    assert abs(losses[0] - jlosses[0]) <= LOSS_TOL * abs(jlosses[0])
    assert_params_close(states[1], port_params(jstates[1]))
    assert_aic_step_freezes(states[1], states[2])
    warm = from_jax_warm(jstates[1], fused=True)
    s, m = pmoe.make_moe_train_step(PCFG, tx, "aic", use_amp=False)(warm, batches["aic"])
    assert abs(float(m["loss"]) - jlosses[1]) <= LOSS_TOL * abs(jlosses[1])
    assert_params_close(s, port_params(jstates[2]))
    assert_aic_step_freezes(warm, s)


def test_int8_moments_freeze_inactive_tasks(plus, jax_steps):
    """C16.  The port: with int8 moments each expert and head has its own
    codes and scales, so the aic step leaves the other tasks' codes and
    scales bit for bit.  JAX: its step cannot take a ``FusedAdam`` at all
    (no ``update``), and its ``_restore_inactive_opt`` on a coded moment
    tree would restore no expert's flat codes (ndim 1) and take every
    expert's (blocks, 1) scales by a one-hot over their size-1 axis: the
    old scales for any task but coco, the active expert's too."""
    sd, tree = plus
    batches, _, _ = jax_steps
    states, losses = run_port(sd, make_fused_adam(LR, moment_dtype="int8"), batches)
    assert all(np.isfinite(losses))
    assert_aic_step_freezes(states[1], states[2])

    jtx = jax_fused_adam(LR, moment_dtype="int8")
    js = jax.jit(lambda t: jmoe.init_moe_train_state(t, jtx))(tree)
    with pytest.raises(AttributeError):          # at trace time: no compile
        jax.jit(jmoe.make_moe_train_step(JCFG, jtx, "aic", use_amp=False))(
            js, {k: jnp.asarray(v) for k, v in batches["aic"].items()}, jax.random.PRNGKey(0))
    old = js["opt_state"].mu
    new, got = jax.jit(lambda o: (lambda n: (n, jmoe._restore_inactive_opt(n, o, "aic")))(
        jax.tree.map(lambda a: a + 1, o)))(old)
    def expert_w(t, part):
        return np.asarray(t[part]["backbone"]["blocks"]["mlp"]["fc2_expert_w"])
    assert expert_w(old, "q_tree").ndim == 1 and expert_w(old, "s_tree").shape[1] == 1
    assert np.array_equal(expert_w(got, "q_tree"), expert_w(new, "q_tree"))   # none restored
    assert np.array_equal(expert_w(got, "s_tree"), expert_w(old, "s_tree"))   # all restored


def test_alternating_schedule_each_loss_falls(plus):
    """Three rounds over the three tasks (the training block's plain
    versions, ``make_optimizer``): each task's loss falls over its steps,
    and the step count and the optimizer's count advance once a step."""
    sd, _ = plus
    rng = np.random.default_rng(5)
    batches = {t: batch(rng, t) for t in TASKS}
    tx = pstep.make_optimizer(LR)
    state = pmoe.init_moe_train_state(sd, tx, device="cpu")
    steps = {t: pmoe.make_moe_train_step(PCFG, tx, t, use_amp=False) for t in TASKS}
    losses = {t: [] for t in TASKS}
    for _ in range(3):
        for t in TASKS:
            state, m = steps[t](state, batches[t])
            losses[t].append(float(m["loss"]))
    for t in TASKS:
        assert losses[t][-1] < losses[t][0], (t, losses[t])
    assert int(state["step"]) == int(state["opt_state"].count) == 9


def test_entry_points_default_to_cuda(plus):
    """``init_moe_train_state`` and ``plus_params`` put the model on CUDA
    unless asked for the CPU, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    sd, _ = plus
    with pytest.raises(RuntimeError, match="CUDA"):
        pmoe.init_moe_train_state(sd, pstep.make_optimizer(LR))
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.plus_params(sd)
    cpu = moe.plus_params({**sd, "associate_keypoint_heads.0.final_layer.weight":
                           torch.zeros(133, 32, 1, 1)}, device="cpu", dtype=torch.bfloat16)
    assert cpu["associate_keypoint_heads.0.final_layer.weight"].shape[0] == 14
    assert cpu["keypoint_head.deconv_layers.1.running_var"].dtype == torch.float32
    assert cpu["backbone.pos_embed"].dtype == torch.bfloat16


def test_step_takes_a_library_loss(plus):
    """``loss_fn=`` takes any loss of ``train/losses.py`` whose shapes fit
    (here OHKM, top 4 of 14 joints): the step's loss is that loss of the
    training forward's heatmaps."""
    import functools
    from easy_vitpose_tpu_torch.train.losses import joints_ohkm_mse_loss
    sd, _ = plus
    b = batch(np.random.default_rng(6), "aic")
    loss_fn = functools.partial(joints_ohkm_mse_loss, topk=4)
    tx = pstep.make_optimizer(LR)
    state = pmoe.init_moe_train_state(sd, tx, device="cpu")
    _, m = pmoe.make_moe_train_step(PCFG, tx, "aic", use_amp=False, loss_fn=loss_fn)(state, b)
    fwd = {**state["params"], **state["bn_state"]["aic"]}
    heat, _ = moe.vitpose_plus_forward_train(fwd, torch.from_numpy(b["images"]), PCFG, "aic")
    want = loss_fn(heat, torch.from_numpy(b["targets"]), torch.from_numpy(b["target_weights"]))
    assert float(m["loss"]) == float(want)
