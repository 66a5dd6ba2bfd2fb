"""PyTorch port: data-parallel training over a process group
(``parallel/mesh.py``, ``train/step.py::make_train_step_sharded``,
``train/moe_step.py::make_moe_train_step_sharded``) against the JAX
package's shard_map steps on two of the eight virtual CPU devices.

Two gloo ranks on the CPU (spawned once for the module,
tests/torch_parallel_workers.py) run the port's sharded step at D=64,
depth 2, 4 heads, drop-path 0.2, on 64x48 crops (12 tokens), a global
batch of 4 (2 rows a rank): two steps at float32, two with
``grad_accum=2`` and two with an EMA, each with JAX's global drop-path
draws given to both; SGD, as tests/test_sharded_train.py takes, so a
step's parameters are linear in its gradients.  JAX runs its XLA block (the
exact erf), the port its training block's plain versions (the A&S erf):
losses within 1e-5 relative, parameters, BatchNorm running statistics and
the EMA within 1e-5 (JAX's EMA is its ``_ema_update`` over its float32
trajectory).  The ranks end bit for bit alike; the sharded step equals the
port's one-process step on the global batch, with the same masks and with
masks drawn from a generator of the same seed (1e-5).

The MoE step's coco step from the initial state is held to JAX's
``make_moe_train_step_sharded`` as tests/test_torch_moe.py holds the
one-process step (Adam's near-zero gradients within the learning rate);
the aic step that follows is held the same way to the port's one-process
step from the same state, and leaves the coco expert and head bit-frozen.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.models.vit import draw_drop_path_masks
from easy_vitpose_tpu.parallel import mesh as jmesh
from easy_vitpose_tpu.train import moe_step as jmoe
from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import (plus_state_dict_from_jax,
                                                     plus_state_dict_to_jax,
                                                     state_dict_from_jax, state_dict_to_jax)
from easy_vitpose_tpu_torch.models import moe
from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks as pdraw
from easy_vitpose_tpu_torch.models.vitpose import init_params
from easy_vitpose_tpu_torch.parallel import mesh as pmesh
from easy_vitpose_tpu_torch.train import moe_step as pmoe
from easy_vitpose_tpu_torch.train import step as pstep
from tests.torch_parallel_workers import SGD, Ranks, numpy, tensors

torch.set_num_threads(1)
LR, B, TOL = 1e-3, 4, 1e-5
HW, MAP = (64, 48), (16, 12)
JCFG = ModelConfig("dp", "coco", BackboneConfig(embed_dim=64, depth=2, num_heads=4,
                                                drop_path_rate=0.2, img_size=HW),
                   HeadConfig(in_channels=64, num_keypoints=17, deconv_filters=(16, 16)))
PCFG = tc.ModelConfig("dp", "coco", tc.BackboneConfig(embed_dim=64, depth=2, num_heads=4,
                                                      drop_path_rate=0.2, img_size=HW),
                      tc.HeadConfig(in_channels=64, num_keypoints=17, deconv_filters=(16, 16)))
EMA = 0.999
MCFG = dataclasses.replace(PCFG, backbone=dataclasses.replace(PCFG.backbone, drop_path_rate=0.0))
JMCFG = dataclasses.replace(JCFG, backbone=dataclasses.replace(JCFG.backbone, drop_path_rate=0.0))
VARIANTS = {"f32": {}, "accum": {"grad_accum": 2}, "ema": {"ema_decay": EMA}}
TASK_K = {"coco": 17, "aic": 14}


def batch(rng, k=17, n=B):
    return {"images": rng.normal(size=(n, *HW, 3)).astype(np.float32),
            "targets": rng.uniform(0, 1, (n, k, *MAP)).astype(np.float32),
            "target_weights": (rng.uniform(size=(n, k, 1)) > 0.1).astype(np.float32)}


def jax_params():
    """The port's numpy-seeded random model (every bias and norm random)
    as JAX's tree."""
    return state_dict_to_jax(init_params(PCFG, 0).state_dict(), PCFG)


def port_state(jstate):
    """JAX's params and BN statistics in the port's names."""
    full = state_dict_from_jax({"backbone": jstate["params"]["backbone"],
                                "head": {**jstate["params"]["head"],
                                         "bn_state": jstate["bn_state"]}}, PCFG)
    params, bn = pstep.split_bn_state(full)
    return numpy(params), numpy(bn)


def jax_steps(tree, mesh, batches, keys, **kw):
    """JAX's sharded step twice from ``tree`` (SGD): the losses and the
    port-named (params, BN statistics) after each step, the first entry
    the initial state's.  The state is replicated on the mesh first, so
    both calls run one compiled program."""
    tx = optax.sgd(LR)
    state = jmesh.replicate(mesh, jstep.init_train_state(tree, tx))
    f = jstep.make_train_step_sharded(JCFG, tx, mesh, use_amp=False, block_impl="xla",
                                      donate_state=False, **kw)
    losses, states = [], [port_state(jax.tree.map(np.asarray, state))]
    for t in range(2):
        state, m = f(state, jmesh.shard_batch(mesh, batches[t]), jmesh.replicate(mesh, keys[t]))
        losses.append(float(m["loss"]))
        states.append(port_state(jax.tree.map(np.asarray, state)))
    return losses, states


def jax_ema(params_trajectory, decay=EMA):
    """JAX's ``_ema_update`` (``e' = d e + (1 - d) p'``, float32) along a
    trajectory of params."""
    e = params_trajectory[0]
    for p in params_trajectory[1:]:
        e = {k: (np.float32(decay) * e[k] + np.float32(1.0 - decay) * p[k]).astype(np.float32)
             for k in e}
    return e


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the ranks, computes JAX's steps while they run, joins them."""
    tree = jax_params()
    rng = np.random.default_rng(1)
    batches = [batch(rng), batch(rng)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    masks = [np.asarray(draw_drop_path_masks(k, JCFG.backbone, B)) for k in keys]
    sd = numpy(state_dict_from_jax(tree, PCFG))
    plus = moe.init_vitpose_plus_params(MCFG, 0, ("coco", "aic"), expert_frac=0.25)
    mrng = np.random.default_rng(4)
    mbatches = {t: batch(mrng, TASK_K[t]) for t in ("coco", "aic")}
    payload = {"cfg": PCFG, "lr": LR, "params": sd, "batches": batches, "masks": masks,
               "seed": 11, "variants": {**VARIANTS, "generator": {}},
               "moe": {"cfg": MCFG, "lr": LR, "params": numpy(plus), "batches": mbatches}}
    ranks = Ranks(2, "dp", tmp_path_factory.mktemp("dp"), payload)

    mesh = jmesh.make_mesh(2)
    jtx = jstep.make_optimizer(LR)
    f = jmoe.make_moe_train_step_sharded(JMCFG, jtx, mesh, "coco", use_amp=False,
                                         block_impl="xla", donate_state=False)
    init = jax.jit(lambda t: jmoe.init_moe_train_state(t, jtx))
    s, m = f(init(plus_state_dict_to_jax(plus, MCFG)), jmesh.shard_batch(mesh, mbatches["coco"]),
             jax.random.PRNGKey(0))
    refs = {"moe": (jax.tree.map(np.asarray, s), float(m["loss"]))}
    for name in ("f32", "accum"):
        refs[name] = jax_steps(tree, mesh, batches, keys, **VARIANTS[name])
    losses, states = refs["f32"]
    refs["ema"] = (losses, states, jax_ema([p for p, _ in states]))
    return payload, refs, ranks.join()


def one_process(payload, masks_of):
    """The port's one-process step on the global batch, two steps."""
    tx = SGD(LR)
    state = pstep.init_train_state(tensors(payload["params"]), tx, device="cpu")
    step = pstep.make_train_step(PCFG, tx, use_amp=False)
    losses = []
    for t in range(2):
        state, m = step(state, payload["batches"][t], drop_path_masks=masks_of(t))
        losses.append(float(m["loss"]))
    return losses, numpy(state["params"]), numpy(state["bn_state"])


def max_diff(a, b):
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_step_matches_jax(run, variant):
    """Two steps of each variant on two ranks against JAX's
    ``make_train_step_sharded`` on two devices: the loss, the parameters,
    the global BatchNorm running statistics and the EMA."""
    _, refs, results = run
    want_losses, states = refs[variant][:2]
    want_p, want_bn = states[-1]
    got = results[0][variant]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL)
    assert max_diff(got["params"], want_p) <= TOL
    assert max_diff(got["bn"], want_bn) <= TOL
    if variant == "ema":
        assert max_diff(got["ema"], refs["ema"][2]) <= TOL
        assert max_diff(got["ema"], got["params"]) > 0


def test_ranks_stay_replicated(run):
    """Every rank ends each variant with the same state, bit for bit."""
    _, _, (r0, r1) = run
    for name in list(VARIANTS) + ["generator"]:
        assert r0[name]["losses"] == r1[name]["losses"]
        assert max_diff(r0[name]["params"], r1[name]["params"]) == 0
        assert max_diff(r0[name]["bn"], r1[name]["bn"]) == 0


def test_sharded_step_equals_one_process_step(run):
    """At ``grad_accum=1`` the sharded step is the one-process step on the
    global batch: with the global masks given, and with the global masks
    drawn from a generator that every rank seeds alike."""
    payload, _, results = run
    for name, masks_of in (
            ("f32", lambda t: torch.tensor(payload["masks"][t])),
            ("generator", lambda t: pdraw(
                PCFG.backbone, B, torch.Generator().manual_seed(payload["seed"] + t)))):
        losses, params, bn = one_process(payload, masks_of)
        got = results[0][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
        assert max_diff(got["params"], params) <= TOL
        assert max_diff(got["bn"], bn) <= TOL


def assert_adam_params_close(state, want):
    """tests/test_torch_moe.py's bound: parameters within 2e-5, those whose
    gradient RMS so far (from the second moment) is under 1e-6 within the
    learning rate."""
    opt = state["opt_state"]
    c2 = 1.0 - 0.999 ** int(opt.count)
    for k, v in want.items():
        d = (state["params"][k] - torch.as_tensor(v)).abs()
        flat = (opt.nu[k] / c2).sqrt() < 1e-6
        assert float(torch.where(flat, 0.0, d).max()) <= 2e-5, k
        assert float(torch.where(flat, d, 0.0).max()) <= LR, k


def test_sharded_moe_step_matches_jax_and_freezes(run):
    """The coco step from the initial state on two ranks against JAX's
    ``make_moe_train_step_sharded`` on two devices; the aic step from that
    state against the port's one-process step from it; the aic step leaves
    the coco expert and head, parameters and moments, bit for bit, and the
    ranks alike."""
    payload, refs, (r0, r1) = run
    jstate, jloss = refs["moe"]
    got = r0["moe"]
    assert abs(got["losses"][0] - jloss) <= TOL * abs(jloss)
    assert_adam_params_close(got["coco"],
                             plus_state_dict_from_jax(jstate["params"], MCFG, bn_state=False))
    tx = pstep.make_optimizer(LR)
    one, m = pmoe.make_moe_train_step(MCFG, tx, "aic", use_amp=False)(
        got["coco"], payload["moe"]["batches"]["aic"])
    assert abs(got["losses"][1] - float(m["loss"])) <= TOL * abs(float(m["loss"]))
    assert_adam_params_close(got["aic"], one["params"])
    before, after = got["coco"], got["aic"]
    frozen = [k for k in before["params"] if not pmoe.is_active(k, "aic")]
    assert len(frozen) == 2 * 2 + 8
    for k in frozen:
        assert torch.equal(after["params"][k], before["params"][k]), k
        for part in ("mu", "nu"):
            assert torch.equal(getattr(after["opt_state"], part)[k],
                               getattr(before["opt_state"], part)[k]), k
    assert int(after["opt_state"].count) == 2
    for k, v in after["params"].items():
        assert torch.equal(v, r1["moe"]["aic"]["params"][k]), k


def test_mesh_helpers_on_one_process():
    """Without a process group: ``initialize_distributed`` of one process
    is a no-op, a ``data`` mesh is this process alone, the main process;
    ``local_batch_slice`` is JAX's slice of one process; a ``batch`` mesh
    over named devices shards rows in per-device blocks and replicates a
    tree per device; the default meshes are CUDA's (raising here)."""
    assert jmesh.local_batch_slice(8) == pmesh.local_batch_slice(8) == slice(0, 8)
    pmesh.initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized() and pmesh.is_main_process()
    m = pmesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group) == (1, 0, None)
    b = pmesh.make_mesh(axis="batch", devices=["cpu", "cpu"])
    rows = pmesh.shard_batch(b, {"x": np.arange(6), "meta": list("abcdef")})
    assert [r["x"].tolist() for r in rows] == [[0, 1, 2], [3, 4, 5]]
    assert [r["meta"] for r in rows] == [list("abc"), list("def")]
    reps = pmesh.replicate(b, {"w": np.ones(2, np.float32)})
    assert len(reps) == 2 and reps[0] is reps[1] and reps[0]["w"].device.type == "cpu"
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_batch(b, {"x": np.arange(5)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="runs on CUDA"):
            pmesh.make_mesh(axis="batch")
        with pytest.raises(RuntimeError, match="runs on CUDA"):
            pmesh.make_mesh()
