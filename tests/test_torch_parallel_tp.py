"""PyTorch port: tensor, expert and pipeline parallelism
(``parallel/tp.py``, ``parallel/pp.py``) against the JAX package's plain
single-device functions.

Four gloo ranks on the CPU (spawned once for the module,
tests/torch_parallel_workers.py), on 64x48 crops (12 tokens):

* TP in layouts (2, 2) and (1, 4), two SGD steps each (lr 0.1) at D=128,
  depth 2, 4 heads, a batch of 8: the trajectory of JAX's single-device
  ``make_train_step`` (the XLA block), which tests/test_tp.py proves JAX's
  TP equals: losses and the global gradient norm (the clip's norm, summed
  over the model shards) within 1e-5 relative, the gathered parameters
  within 1e-5, as there.  SGD keeps the parameters linear in the
  gradients: with Adam the port's one-process step already differs from
  JAX's by up to 5e-5 after two steps where a gradient's two values nearly
  cancel (measured here), which the TP layout would only hide.  The qkv
  weight is really split.  JAX's ``jit_tensor_parallel`` is not run here.
* EP over the (2, 2) layout's model groups (2 ranks, 2 experts, one each):
  each task's forward, its expert fetched from the rank that holds it,
  against JAX's unsharded ``vitpose_plus_forward`` (1e-5 of the largest
  value, tests/test_torch_moe.py's bound) and bit for bit against the
  port's unsharded forward; the expert's gradient reaches its owner bit
  for bit.
* PP at 2 stages (ranks {0, 1} and {2, 3}) and 4 stages, depth 4, a batch
  of 4 in 2 micro-batches: the backbone's output and the gradient of every
  weight each stage holds, of ``sum(out * cot)``, against JAX's plain
  ``vit_forward`` and its VJP, to 1e-5 (never against JAX's
  ``pipeline_vit_forward``); a depth that the stages do not divide raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.models.moe import vitpose_plus_forward as jax_plus_forward
from easy_vitpose_tpu.models.vit import vit_forward
from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu_torch import configs as tc
from easy_vitpose_tpu_torch.convert.from_jax import (plus_state_dict_to_jax, state_dict_from_jax,
                                                     state_dict_to_jax)
from easy_vitpose_tpu_torch.models import moe
from easy_vitpose_tpu_torch.models.vitpose import init_params
from tests.torch_parallel_workers import Ranks, numpy

torch.set_num_threads(1)
HW, MAP, TOL, TP_LR = (64, 48), (16, 12), 1e-5, 0.1


def cfgs(name, d, depth, heads=4):
    kw = dict(embed_dim=d, depth=depth, num_heads=heads, img_size=HW)
    return (ModelConfig(name, "coco", BackboneConfig(**kw),
                        HeadConfig(in_channels=d, num_keypoints=17, deconv_filters=(16, 16))),
            tc.ModelConfig(name, "coco", tc.BackboneConfig(**kw),
                           tc.HeadConfig(in_channels=d, num_keypoints=17,
                                         deconv_filters=(16, 16))))


TP_J, TP_P = cfgs("tp", 128, 2)
EP_J, EP_P = cfgs("ep", 64, 2)
PP_J, PP_P = cfgs("pp", 64, 4)


def tree_params(tree):
    return state_dict_from_jax(tree, TP_P, bn_state=False)


def tp_batch(rng, n=8):
    return {"images": rng.normal(size=(n, *HW, 3)).astype(np.float32),
            "targets": rng.uniform(0, 1, (n, 17, *MAP)).astype(np.float32),
            "target_weights": np.ones((n, 17, 1), np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the ranks, computes JAX's references while they run, joins."""
    rng = np.random.default_rng(0)
    tp_sd = numpy(init_params(TP_P, 0).state_dict())
    batch = tp_batch(rng)
    plus = numpy(moe.init_vitpose_plus_params(EP_P, 1, ("coco", "aic"), expert_frac=0.25))
    crops = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    ep_cot = {t: rng.normal(size=(2, k, *MAP)).astype(np.float32)
              for t, k in (("coco", 17), ("aic", 14))}
    pp_sd = numpy(init_params(PP_P, 2).state_dict())
    x = rng.normal(size=(4, *HW, 3)).astype(np.float32)
    pp_cot = rng.normal(size=(4, *PP_P.backbone.patch_shape, 64)).astype(np.float32)
    payload = {"tp": {"cfg": TP_P, "lr": TP_LR, "params": tp_sd, "batch": batch},
               "ep": {"cfg": EP_P, "params": plus, "crops": crops, "cot": ep_cot},
               "pp": {"cfg": PP_P, "params": pp_sd, "x": x, "cot": pp_cot, "n_micro": 2}}
    ranks = Ranks(4, "model_parallel", tmp_path_factory.mktemp("mp"), payload)

    # TP: JAX's single-device trajectory
    tree = state_dict_to_jax(tp_sd, TP_P)
    tx = optax.sgd(TP_LR)
    state = jax.jit(lambda t: jstep.init_train_state(t, tx))(tree)
    step = jax.jit(jstep.make_train_step(TP_J, tx, use_amp=False))
    metrics = []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        state, m = step(state, jb, jax.random.PRNGKey(1))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    tp_want = (metrics, numpy(tree_params(tree)),
               numpy(tree_params(jax.tree.map(np.asarray, state["params"]))))
    # EP: JAX's unsharded forward per task
    ptree = plus_state_dict_to_jax({k: torch.from_numpy(v) for k, v in plus.items()}, EP_P)
    fwd = jax.jit(jax_plus_forward, static_argnums=(2, 3))
    ep_want = {t: np.asarray(fwd(ptree, jnp.asarray(crops), EP_J, t)) for t in ("coco", "aic")}
    # PP: JAX's plain backbone and its VJP
    ptree = state_dict_to_jax(pp_sd, PP_P)

    @jax.jit
    def forward_and_vjp(bb, x, cot):
        out, vjp = jax.vjp(lambda b: vit_forward(b, x, PP_J.backbone), bb)
        return out, vjp(cot)[0]
    out, g = forward_and_vjp(ptree["backbone"], jnp.asarray(x), jnp.asarray(pp_cot))
    grads = numpy(state_dict_from_jax({"backbone": jax.tree.map(np.asarray, g),
                                       "head": ptree["head"]}, PP_P, bn_state=False))
    pp_want = {"out": np.asarray(out),
               "grads": {k: v for k, v in grads.items() if k.startswith("backbone.")}}
    return {"tp": tp_want, "ep": ep_want, "pp": pp_want}, ranks.join()


@pytest.mark.parametrize("layout", [(2, 2), (1, 4)])
def test_tp_matches_single_device_trajectory(run, layout):
    """Two TP steps against JAX's single-device steps: every rank's loss
    and gradient norm, the gathered parameters (which moved); the qkv
    weight's shard holds 1 / n_model of its rows."""
    want, results = run
    metrics, before, want = want["tp"]
    for r in results:
        got = r["tp"][layout]
        np.testing.assert_allclose(got["metrics"], metrics, rtol=TOL)
        assert got["qkv_shard"] == (3 * 128 // layout[1], 128)
    got = results[0]["tp"][layout]["params"]
    assert sorted(got) == sorted(want)
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) < TOL
    assert max(float(np.abs(want[k] - before[k]).max()) for k in want) > 1e-3


def test_ep_forward_and_gradient(run):
    """Each rank of a model group holds one expert; each task's forward
    equals JAX's unsharded forward and the port's own; the fetched expert's
    gradient reaches only its owner, equal to the unsharded gradient."""
    (want, results) = run
    for rank, r in enumerate(results):
        ep = r["ep"]
        owned = rank % 2                     # the model rank: expert e on rank e
        assert {k.split(".experts.")[1].split(".")[0] for k in ep["held"]} == {str(owned)}
        for e, task in enumerate(("coco", "aic")):
            got = ep[task]
            ref = want["ep"][task]
            assert np.abs(got["heat"] - ref).max() <= TOL * np.abs(ref).max()
            assert got["equal_to_unsharded"]
            if e == owned:
                assert got["expert_grad_err"] == 0 and got["expert_grad_scale"] > 0
            else:
                assert got["expert_grad_err"] is None


@pytest.mark.parametrize("stages", [2, 4])
def test_pp_forward_and_gradients(run, stages):
    """Every stage's output, and each stage's gradients (the replicated
    embeddings and last norm whole, its own layers), against JAX."""
    (want, results) = run
    want = want["pp"]
    scale = np.abs(want["out"]).max()
    held = set()
    for rank, r in enumerate(results[:stages]):
        got = r["pp"][stages]
        assert got["layers"] == list(range(rank * 4 // stages, (rank + 1) * 4 // stages))
        assert np.abs(got["out"] - want["out"]).max() <= TOL * scale
        for k, g in got["grads"].items():
            ref = want["grads"][k]
            assert np.abs(g - ref).max() <= TOL * max(np.abs(ref).max(), 1.0), (stages, rank, k)
        held |= set(got["grads"])
    assert held == set(want["grads"])
    assert all(r["pp_depth_raises"] for r in results)
