"""PyTorch port: the optimizers of the training loop against optax, and the
step on a host-rendered batch.

The JAX package builds its non-fused optimizers as optax chains
(``train/step.py:29-177``); the port runs the same float32 operations in
plain torch (``train/step.py::make_optimizer``,
``make_adamw_layer_decay_optimizer``, ``make_step_lr_schedule``).  Each is
driven for three updates from the same weights (the tiny config's random
init in the JAX package's tree, carried to the port's names by
``convert.from_jax.state_dict_from_jax``) with the same gradients, whose
global norm is 3, 0.5 and 2 (the clip on, off, on).  An update moves a
weight by about lr, so the params are held to 1e-5 of lr plus one rounding
of the weight (sums of squares and the bias correction's power round in
another order) and the moments to 1e-5 of each leaf's largest value (the
clipped gradients differ in their last bits through the norm; measured
1.5e-6).

JAX's ``make_adamw_layer_decay_optimizer`` hands its weight-decay mask to
``optax.inject_hyperparams``, which takes any callable argument for a
schedule: the mask becomes ``True`` and every leaf is decayed.  The port
applies the mask the recipe names (biases, norms, the position embedding
and the patch bias get none), so it is held against that chain built with
the mask as a static argument, and the shipped chain's behaviour is pinned
on its own (ROADMAP queue C).
"""
import dataclasses
import functools
import operator

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu.train.fused_opt import make_fused_adam as jax_fused_adam
from easy_vitpose_tpu_torch.convert.from_jax import (_TO_TORCH, jax_leaves, state_dict_from_jax,
                                                    state_dict_to_jax)
from easy_vitpose_tpu_torch.train import step as pstep
from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam
from easy_vitpose_tpu_torch.models.vitpose import init_params
from tests.test_torch_train_step import CFG, PCFG, port_tree, raw_batch

LR = 1e-3
NORMS = (3.0, 0.5, 2.0)           # the clip on, off, on


def grads_like(tree, rng, norm):
    """Random gradients of ``tree``'s shapes with global norm ``norm``."""
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    n = float(np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in jax.tree.leaves(g))))
    return jax.tree.map(lambda x: jnp.asarray(x * np.float32(norm / n)), g)


def jax_params(seed=0):
    """Random tiny-config params in the JAX package's tree (numpy leaves),
    every leaf random (the port's ``init_params``, carried across)."""
    return state_dict_to_jax(init_params(PCFG, seed).state_dict(), PCFG)


def jax_trainable(seed=0):
    return jstep.split_bn_state(jax_params(seed))[0]


def run_both(tx_j, tx_p, norms=NORMS, seed=0):
    """(JAX params, state, norm) and the port's after each update."""
    tr_j = jax_trainable(seed)
    tr_p = port_tree(tr_j)
    st_j, st_p = tx_j.init(tr_j), tx_p.init(tr_p)

    def apply_j(g, s, p):
        # eager: its per-op programs compile once a process, a jit once a chain
        return jstep.apply_optimizer(tx_j, g, s, p)

    rng, out = np.random.default_rng(seed + 1), []
    for norm in norms:
        g = grads_like(tr_j, rng, norm)
        tr_j, st_j, gn_j = apply_j(g, st_j, tr_j)
        tr_p, st_p, gn_p = pstep.apply_optimizer(tx_p, port_tree(g), st_p, tr_p)
        out.append(((tr_j, st_j, gn_j), (tr_p, st_p, gn_p)))
    return out


def assert_params_close(tr_j, tr_p, lr=LR):
    """Each weight within 1e-5 of lr, plus one rounding of the weight
    (the add of an update that differs in its last bits)."""
    ref = port_tree(tr_j)
    assert set(ref) == set(tr_p)
    for k, v in tr_p.items():
        r = ref[k]
        assert bool(((v - r).abs() <= 1e-5 * lr + 2.0 ** -23 * r.abs()).all()), k


def assert_moments_close(st_j, st_p):
    for name in ("mu", "nu"):
        tree = optax.tree_utils.tree_get(st_j, name)
        for k, v in getattr(st_p, name).items():
            ref = port_tree_leaf(tree, k)
            assert float((v - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-30, (name, k)


def port_tree_leaf(tree, name):
    """One leaf of a JAX trainable tree (which may hold optax's masked
    nodes) in the port's layout."""
    leaf = jax_leaves(PCFG, bn_state=False)[name]
    x = functools.reduce(operator.getitem, leaf.path, tree)
    x = x if leaf.layer is None else x[leaf.layer]
    return torch.from_numpy(_TO_TORCH[leaf.kind](x, PCFG))


@pytest.mark.parametrize("freeze", [False, True])
def test_adam_matches_optax(freeze):
    """``make_optimizer``: clip + inject_hyperparams(adam), and with
    ``freeze_backbone`` optax's multi_transform: the norm and the clip over
    the head's gradients only, no backbone moments, the backbone unchanged
    bit for bit.  The returned norm is every gradient's."""
    runs = run_both(jstep.make_optimizer(LR, freeze_backbone=freeze),
                    pstep.make_optimizer(LR, freeze_backbone=freeze))
    tr0 = port_tree(jax_trainable())
    for (tr_j, st_j, gn_j), (tr_p, st_p, gn_p) in runs:
        assert_params_close(tr_j, tr_p)
        assert abs(float(gn_p) - float(gn_j)) <= 1e-6 * float(gn_j)
        assert_moments_close(st_j, st_p)
        assert pstep.get_learning_rate(st_p) == jstep.get_learning_rate(st_j) == np.float32(LR)
        if freeze:
            assert all(not k.startswith("backbone.") for k in st_p.mu)
            for k, v in tr_p.items():
                assert torch.equal(v, tr0[k]) == k.startswith("backbone."), k
    assert int(runs[-1][1][1].count) == 3


def test_freeze_clips_by_the_head_norm_only():
    """With a backbone gradient far above the clip and a head gradient
    below it, the head's update is unclipped (the same as with the backbone
    gradient zeroed), as under optax.multi_transform."""
    tr = port_tree(jax_trainable())
    rng = np.random.default_rng(3)
    g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
         * (100.0 if k.startswith("backbone.") else 1e-4) for k, v in tr.items()}
    g0 = {k: v * 0 if k.startswith("backbone.") else v for k, v in g.items()}
    tx = pstep.make_optimizer(LR, freeze_backbone=True)
    a = pstep.apply_optimizer(tx, g, tx.init(tr), tr)[0]
    b = pstep.apply_optimizer(tx, g0, tx.init(tr), tr)[0]
    for k in tr:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture
def masked_adamw(monkeypatch):
    """JAX's AdamW layer-decay chain with its weight-decay mask taken as
    the static argument it was written to be."""
    real = optax.inject_hyperparams

    def inject(factory, static_args=(), **kw):
        return real(factory, static_args=tuple(static_args) + ("mask",), **kw)

    monkeypatch.setattr(optax, "inject_hyperparams", inject)
    return jstep.make_adamw_layer_decay_optimizer


def test_adamw_layer_decay_with_schedule_matches_optax(masked_adamw):
    """AdamW + layer decay + clip under the warmup and milestone schedule
    (which moves at every update here): params, moments and the realized
    learning rate (the schedule at the count before each update)."""
    kw = dict(steps_per_epoch=1, milestones=(1, 2), gamma=0.5, warmup_iters=2, warmup_ratio=0.1)
    sj = jstep.make_step_lr_schedule(LR, **kw)
    sp = pstep.make_step_lr_schedule(LR, **kw)
    runs = run_both(masked_adamw(sj, weight_decay=0.1, layer_decay_rate=0.6, depth=2),
                    pstep.make_adamw_layer_decay_optimizer(sp, 0.1, 0.6, cfg=PCFG))
    for t, ((tr_j, st_j, _), (tr_p, st_p, _)) in enumerate(runs):
        assert_params_close(tr_j, tr_p)
        assert_moments_close(st_j, st_p)
        lr = pstep.get_learning_rate(st_p)
        assert lr == jstep.get_learning_rate(st_j) == float(sp(t))


def zero_grad_update(apply, tr):
    """The first update with zero gradients and all weights one: -lr * wd *
    scale where a leaf decays, else 0 (Adam's own term is 0)."""
    ones = jax.tree.map(jnp.ones_like, tr)
    new = apply(jax.tree.map(jnp.zeros_like, ones), ones)
    return {k: v - 1.0 for k, v in port_tree(new).items()}


def test_weight_decay_mask_and_layer_scale_match_jax(masked_adamw):
    """Per leaf, through the name map: the port's weight-decay mask and
    layer scale give JAX's masked chain's zero-gradient update, and the
    port's own update is that one."""
    tr_j = jax_trainable()
    tx_j = masked_adamw(LR, weight_decay=0.1, layer_decay_rate=0.6, depth=2)

    def apply_j(g, p):
        return jstep.apply_optimizer(tx_j, g, tx_j.init(p), p)[0]

    ref = zero_grad_update(apply_j, tr_j)
    mask, scale = pstep.weight_decay_mask(PCFG), pstep.layerwise_lr_decay(0.6, PCFG)
    tx_p = pstep.make_adamw_layer_decay_optimizer(LR, 0.1, 0.6, cfg=PCFG)
    ones = {k: torch.ones_like(v) for k, v in port_tree(tr_j).items()}
    got = pstep.apply_optimizer(tx_p, {k: torch.zeros_like(v) for k, v in ones.items()},
                                tx_p.init(ones), ones)[0]
    decayed = 0
    for k, r in ref.items():
        want = -LR * 0.1 * scale(k) * mask(k)
        assert float((r - want).abs().max()) <= 2.0 ** -23, k       # one rounding of 1 + u
        assert float((got[k] - 1.0 - want).abs().max()) <= 2.0 ** -23, k
        decayed += mask(k)
    assert decayed == 2 * 4 + 1 + 2 + 1            # the linears, patch, deconvs, final conv
    assert scale("keypoint_head.final_layer.weight") == 1.0
    assert scale("backbone.blocks.1.attn.qkv.weight") == 1.0
    assert scale("backbone.blocks.0.attn.qkv.weight") == pytest.approx(0.6)
    assert scale("backbone.pos_embed") == pytest.approx(0.36)


def test_jax_shipped_adamw_decays_every_leaf():
    """The divergence the port does not copy: the JAX package's own chain
    (its mask taken for a schedule) decays the leaves its mask exempts."""
    tr_j = jax_trainable()
    tx_j = jstep.make_adamw_layer_decay_optimizer(LR, weight_decay=0.1, layer_decay_rate=0.6,
                                                  depth=2)
    ref = zero_grad_update(lambda g, p: jstep.apply_optimizer(tx_j, g, tx_j.init(p), p)[0], tr_j)
    assert not pstep.weight_decay_mask(PCFG)("backbone.blocks.0.norm1.bias")
    assert all(float(v.abs().min()) > 0 for v in ref.values())


def test_step_schedule_matches_jax():
    """The warmup ramp, the milestones by epoch and the plateau after the
    warmup, at every count of 14 updates (3 a epoch), from int and tensor
    counts: equal to JAX's to float32 rounding (rel 1e-6)."""
    kw = dict(steps_per_epoch=3, milestones=(2, 3), gamma=0.1, warmup_iters=5, warmup_ratio=1e-3)
    sj, sp = jstep.make_step_lr_schedule(5e-4, **kw), pstep.make_step_lr_schedule(5e-4, **kw)
    for c in range(14):
        ref = float(sj(c))
        for count in (c, torch.tensor(c, dtype=torch.int32)):
            got = sp(count)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - ref) <= 1e-6 * ref, c
    # base * ratio at count 0 (1 - 0.999 cancels in float32), base * gamma^2
    # once epoch 3 has passed both milestones and the warmup is over
    assert float(sp(0)) == pytest.approx(5e-7, rel=1e-4)
    assert float(sp(9)) == pytest.approx(5e-6, rel=1e-6)


@pytest.mark.parametrize("kind", ["fused", "adam"])
def test_set_and_get_learning_rate(kind):
    """On both kinds of state: ``set_learning_rate`` changes the rate the
    next update uses (0 leaves the params as they are) and
    ``get_learning_rate`` reads it."""
    tr = port_tree(jax_trainable())
    tx = make_fused_adam(LR) if kind == "fused" else pstep.make_optimizer(LR)
    st = tx.init(tr)
    assert pstep.get_learning_rate(st) == np.float32(LR)
    st = pstep.set_learning_rate(st, 0.0)
    assert pstep.get_learning_rate(st) == 0.0
    g = {k: torch.ones_like(v) for k, v in tr.items()}
    new, st, _ = pstep.apply_optimizer(tx, g, st, tr)
    for k in tr:
        assert torch.equal(new[k], tr[k]), k
    st = pstep.set_learning_rate(st, 2e-3)
    new, st, _ = pstep.apply_optimizer(tx, g, st, tr)
    assert pstep.get_learning_rate(st) == np.float32(2e-3)
    assert float((new["backbone.pos_embed"] - tr["backbone.pos_embed"]).abs().max()) > 1e-3


def test_fused_adam_takes_a_schedule():
    """``make_fused_adam`` with a schedule, as JAX's: the rate at the count
    before each update, on the device, and the params of JAX's fused Adam
    (its ``xla`` flavor) over three updates."""
    kw = dict(steps_per_epoch=1, milestones=(1, 2), gamma=0.5, warmup_iters=2, warmup_ratio=0.1)
    sj, sp = jstep.make_step_lr_schedule(LR, **kw), pstep.make_step_lr_schedule(LR, **kw)
    runs = run_both(jax_fused_adam(sj), make_fused_adam(sp))
    assert pstep.get_learning_rate(make_fused_adam(sp).init(port_tree(jax_trainable()))) \
        == float(sp(0))
    for t, ((tr_j, st_j, _), (tr_p, st_p, _)) in enumerate(runs):
        assert_params_close(tr_j, tr_p)
        assert pstep.get_learning_rate(st_p) == float(st_j.hyperparams["learning_rate"]) \
            == float(sp(t))


def no_drop_path(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, drop_path_rate=0.0))


def test_host_rendered_batch_step_matches_jax():
    """The repaired pass-through: a host-rendered batch (images, targets,
    weights; the JAX loop's validation batches and its default training
    batch) goes through the port's train step as through JAX's: float32,
    the XLA block both sides, no drop path: loss to 1e-5, the gradients
    (from the first Adam moment) to 1e-4 of each leaf's largest.  The eval
    step takes it too: the loss and heatmaps of the same batch in device-input
    form (held to JAX's eval step in tests/test_torch_train_step.py), to
    1e-5 (the two renders agree to 1e-6)."""
    cfg, pcfg = no_drop_path(CFG), no_drop_path(PCFG)
    params = jax_params(2)
    raw = raw_batch(np.random.default_rng(5), 2)
    host = {k: np.asarray(v) for k, v in jstep.render_batch_on_device(
        {k: jnp.asarray(v) for k, v in raw.items()}).items()}
    host["meta"] = [{}, {}]
    got = pstep.render_batch_on_device(host, device="cpu")
    assert set(got) == {"images", "targets", "target_weights"}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), host[k])

    tx_j, tx_p = jax_fused_adam(LR), make_fused_adam(LR)
    js = jstep.init_train_state(params, tx_j)
    jb = {k: jnp.asarray(v) for k, v in host.items() if k != "meta"}
    js1, jm = jax.jit(jstep.make_train_step(cfg, tx_j, use_amp=False, block_impl="xla"))(
        js, jb, jax.random.PRNGKey(0))
    ps = pstep.init_train_state(state_dict_from_jax(params, pcfg), tx_p, device="cpu")
    ps1, pm = pstep.make_train_step(pcfg, tx_p, use_amp=False, block_impl="xla")(ps, host)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    scale_j = 0.1 * min(1.0, 1.0 / float(jm["grad_norm"]))
    scale_p = 0.1 * min(1.0, 1.0 / float(pm["grad_norm"]))
    jg = port_tree(js1["opt_state"].mu)
    for k, v in ps1["opt_state"].mu.items():
        ref = jg[k].numpy() / scale_j
        assert np.abs(v.numpy() / scale_p - ref).max() <= 1e-4 * np.abs(ref).max(), k

    ev = pstep.make_eval_step(pcfg, use_amp=False, return_heatmaps=True)
    (hl, hh), (rl, rh) = ev(ps, host), ev(ps, raw)
    assert abs(float(hl) - float(rl)) <= 1e-5 * float(rl)
    assert float((hh - rh).abs().max()) <= 1e-5 * float(rh.abs().max())
