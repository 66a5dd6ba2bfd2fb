"""PyTorch port: ViTPose+ multi-task checkpoints and ``VitInference(task=)``
against the JAX package, on the CPU.

A synthetic reference-layout ViTPose+ state dict (six experts, a main head
and five associate heads of 133 rows, truncated per task as the splitter
does) at a tiny width, converted by the JAX package's ``convert plus``
layout: for each of the six tasks the port's ``VitInference(plus.npz,
task=t)`` is held to JAX's with the bounds of tests/test_torch_inference.py
(scores within 1e-5, coordinates within 0.5 px except at most 2 of a
person's keypoints, the median within 0.01 px), and to the port's own run
of the split single-task checkpoint bit for bit (the weights are spliced
the same way).
"""
import dataclasses

import numpy as np
import pytest
import torch

from easy_vitpose_tpu import VitInference as JVI
from easy_vitpose_tpu.configs import BackboneConfig, HeadConfig, ModelConfig
from easy_vitpose_tpu.convert.model_split import split_vitpose_plus as jsplit
from easy_vitpose_tpu.convert.vitpose_plus import convert_vitpose_plus_state_dict as jconvert
from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict as jconvert_single
from easy_vitpose_tpu.utils.checkpoint import save_params
from easy_vitpose_tpu_torch.convert.model_split import SPLIT_DATASETS, SPLIT_NUM_KPTS
from easy_vitpose_tpu_torch.convert.vitpose_plus import (convert_vitpose_plus_state_dict,
                                                         is_plus_params, select_task)
from easy_vitpose_tpu_torch.pipeline.inference import VitInference as PVI
from tests.test_torch_inference import Keypoints
from tests.test_torch_model import port_config

torch.set_num_threads(1)
D, DEPTH, HEADS, HIDDEN = 64, 2, 4, 256
D_SHARED, D_EXP = 48, 16          # part-shared FFN split (sums to D)
FILTERS = (16, 16)
JCFG = ModelConfig(name="plustiny", dataset="coco",
                   backbone=BackboneConfig(embed_dim=D, depth=DEPTH, num_heads=HEADS),
                   head=HeadConfig(in_channels=D, num_keypoints=17, deconv_filters=FILTERS))


def task_cfg(task: str, jax: bool = True):
    cfg = dataclasses.replace(JCFG, dataset=task, head=dataclasses.replace(
        JCFG.head, num_keypoints=SPLIT_NUM_KPTS[task]))
    return cfg if jax else port_config(cfg)


def _head(rng, prefix, k):
    sd, cin = {}, D
    for i, f in enumerate(FILTERS):
        base = f"{prefix}.deconv_layers.{3 * i}"
        sd[base + ".weight"] = rng.normal(0, 1 / np.sqrt(cin * 4), (cin, f, 4, 4)).astype(np.float32)
        bn = f"{prefix}.deconv_layers.{3 * i + 1}"
        sd[bn + ".weight"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
        sd[bn + ".bias"] = rng.normal(0, 0.1, f).astype(np.float32)
        sd[bn + ".running_mean"] = rng.normal(0, 0.3, f).astype(np.float32)
        sd[bn + ".running_var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
        sd[bn + ".num_batches_tracked"] = np.zeros((), np.int64)
        cin = f
    sd[f"{prefix}.final_layer.weight"] = rng.normal(0, 0.02, (k, cin, 1, 1)).astype(np.float32)
    sd[f"{prefix}.final_layer.bias"] = rng.normal(0, 0.02, (k,)).astype(np.float32)
    return sd


def make_plus_sd(seed: int = 0):
    """A reference-layout ViTPose+ state dict with six experts."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=0.05: rng.normal(0, s, shape).astype(np.float32)  # noqa: E731
    sd = {"backbone.patch_embed.proj.weight": f(D, 3, 16, 16),
          "backbone.patch_embed.proj.bias": f(D, s=0.02),
          "backbone.pos_embed": f(1, 193, D, s=0.02),
          "backbone.last_norm.weight": rng.uniform(0.5, 1.5, D).astype(np.float32),
          "backbone.last_norm.bias": f(D, s=0.1)}
    for i in range(DEPTH):
        p = f"backbone.blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = rng.uniform(0.5, 1.5, D).astype(np.float32)
            sd[f"{p}.{n}.bias"] = f(D, s=0.1)
        sd[p + ".attn.qkv.weight"], sd[p + ".attn.qkv.bias"] = f(3 * D, D), f(3 * D, s=0.02)
        sd[p + ".attn.proj.weight"], sd[p + ".attn.proj.bias"] = f(D, D), f(D, s=0.02)
        sd[p + ".mlp.fc1.weight"], sd[p + ".mlp.fc1.bias"] = f(HIDDEN, D), f(HIDDEN, s=0.02)
        sd[p + ".mlp.fc2.weight"] = f(D_SHARED, HIDDEN)
        sd[p + ".mlp.fc2.bias"] = f(D_SHARED, s=0.02)
        for e in range(len(SPLIT_DATASETS)):
            sd[f"{p}.mlp.experts.{e}.weight"] = f(D_EXP, HIDDEN)
            sd[f"{p}.mlp.experts.{e}.bias"] = f(D_EXP, s=0.02)
    sd.update(_head(rng, "keypoint_head", 17))
    for j in range(5):
        sd.update(_head(rng, f"associate_keypoint_heads.{j}", 133))
    return sd


@pytest.fixture(scope="module")
def plus(tmp_path_factory):
    d = tmp_path_factory.mktemp("plus")
    sd = make_plus_sd()
    path = str(d / "vitpose-plus.npz")
    save_params(path, jconvert(sd, JCFG))
    return {"sd": sd, "npz": path, "dir": d}


def frame_boxes(seed=2):
    frame = np.random.default_rng(seed).integers(0, 255, (240, 320, 3), np.uint8)
    return frame, np.array([[30, 20, 160, 200, 0.9], [120, 40, 300, 230, 0.8]], np.float32)


def test_plus_tree_matches_jax(plus):
    """The port's multi-task tree and every task's spliced tree equal JAX's
    bit for bit."""
    from easy_vitpose_tpu.convert.vitpose_plus import select_task as jselect
    from easy_vitpose_tpu_torch.utils.checkpoint import flatten_params
    ref = jconvert(plus["sd"], JCFG)
    got = convert_vitpose_plus_state_dict({k: torch.from_numpy(v) for k, v in plus["sd"].items()},
                                          port_config(JCFG))
    assert is_plus_params(got) and sorted(got["heads"]) == sorted(SPLIT_DATASETS)
    for a, b in ((got, ref),) + tuple((select_task(got, t), jselect(ref, t))
                                      for t in SPLIT_DATASETS):
        fa, fb = flatten_params(a), flatten_params(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    with pytest.raises(ValueError, match="not a ViTPose"):
        convert_vitpose_plus_state_dict({"backbone.pos_embed": np.zeros(3)}, port_config(JCFG))
    # the port's loader rebuilds the .npz's tree as JAX's does: heads/<task>/...
    # with their deconv lists, and the stacked expert leaves
    from easy_vitpose_tpu.utils.checkpoint import load_params as jload
    from easy_vitpose_tpu_torch.utils.checkpoint import load_params
    got, ref = load_params(plus["npz"]), jload(plus["npz"])
    assert sorted(got["heads"]) == sorted(ref["heads"]) == sorted(SPLIT_DATASETS)
    assert isinstance(got["heads"]["aic"]["deconv"], list)
    assert got["backbone"]["blocks"]["mlp"]["fc2_expert_w"].shape == (DEPTH, 6, HIDDEN, D_EXP)
    fa, fb = flatten_params(got), flatten_params(ref)
    assert fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("task", SPLIT_DATASETS)
def test_vitinference_task_matches_jax_and_split(plus, task):
    frame, boxes = frame_boxes()
    j = JVI(plus["npz"], model_name="s", model_cfg=task_cfg(task), task=task)
    p = PVI(plus["npz"], model_name="s", model_cfg=task_cfg(task, jax=False), task=task,
            device="cpu")
    assert p.dataset == j.dataset == task
    got = p.inference(frame, bboxes=boxes)
    assert all(v.shape == (SPLIT_NUM_KPTS[task], 3) for v in got.values())
    kp = Keypoints()
    kp.add(j.inference(frame, bboxes=boxes), got)
    kp.check(min_people=2)
    # the reference splitter's single-task checkpoint serves the same bits
    split = str(plus["dir"] / f"vitpose-s-{task}.npz")
    save_params(split, jconvert_single(jsplit(plus["sd"])[task], task_cfg(task)))
    s = PVI(split, model_name="s", model_cfg=task_cfg(task, jax=False), device="cpu")
    assert s.dataset == task
    ref = s.inference(frame, bboxes=boxes)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


def test_task_errors_match_jax(plus, tmp_path):
    single = str(tmp_path / "vitpose-s-coco.npz")
    save_params(single, jconvert_single(jsplit(plus["sd"])["coco"], JCFG))
    pcfg = port_config(JCFG)
    with pytest.raises(ValueError, match="multi-task"):
        PVI(single, model_name="s", model_cfg=pcfg, task="mpii", device="cpu")
    with pytest.raises(ValueError):
        JVI(single, model_name="s", model_cfg=JCFG, task="mpii")
    # a task the checkpoint has no head for names the ones it has
    sd = {k: v for k, v in plus["sd"].items() if "associate_keypoint_heads.2" not in k}
    part = str(tmp_path / "vitpose-plus-part.npz")
    save_params(part, jconvert(sd, JCFG))
    with pytest.raises(KeyError, match="has:"):
        PVI(part, model_name="s", model_cfg=pcfg, task="ap10k", device="cpu")
    with pytest.raises(KeyError):
        JVI(part, model_name="s", model_cfg=JCFG, task="ap10k")


def test_plus_int8_serves_through_the_int8_blocks(plus):
    from easy_vitpose_tpu_torch.models.quant import QBlock
    frame, boxes = frame_boxes(3)
    p = PVI(plus["npz"], model_name="s", model_cfg=task_cfg("aic", jax=False), task="aic",
            dtype="int8", device="cpu")
    assert all(isinstance(b, QBlock) for b in p._model.backbone.blocks)
    out = p.inference(frame, bboxes=boxes)
    assert out[0].shape == (14, 3) and all(np.isfinite(v).all() for v in out.values())
