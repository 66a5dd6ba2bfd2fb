"""PyTorch port: the whole pose step (crop -> backbone -> head -> UDP
decode -> un-crop) vs the JAX pose step and the reference keypoints of
tests/golden/pipeline_golden.npz, at fp32 and int8, with flip test and
masked slots.  CPU only: every kernel's wrapper takes its plain version.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import IMAGE_SIZE
from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict
from easy_vitpose_tpu.models.quant import quantize_vit_params
from easy_vitpose_tpu.models.vitpose import vitpose_forward as jax_forward
from easy_vitpose_tpu.ops import preprocess as jpre
from easy_vitpose_tpu.ops.affine import flip_back_heatmaps as jax_flip_back
from easy_vitpose_tpu.pipeline.pose_step import pose_step_jit
from easy_vitpose_tpu.skeletons import flip_pairs
from easy_vitpose_tpu_torch.models.vitpose import serving_copy
from easy_vitpose_tpu_torch.pipeline.pose_step import bucket_slots, pose_heatmaps, pose_step
from tests.test_model_parity import CASES as JAX_CASES
from tests.test_model_parity import load_case
from tests.test_torch_model import port_model

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipeline_golden.npz")
PAIRS = flip_pairs("coco")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def tiny():
    sd, _, _ = load_case("tiny")
    params = convert_vitpose_state_dict(sd, JAX_CASES["tiny"])
    return params, port_model(params, "tiny")


def padded(boxes, M):
    b = np.zeros((M, 4), np.float32)
    b[:len(boxes)] = boxes
    return b, np.arange(M) < len(boxes)


def random_scene(seed):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    boxes = np.array([[30, 20, 160, 200], [100.5, 40.5, 280.5, 230.5],
                      [-10, 150, 60, 260], [300, 5, 330, 60], [150, 100, 151, 101]], np.float32)
    return frame, boxes


def jax_heatmaps(params, frame, boxes, *, pairs=None, dtype=jnp.float32, block_impl="xla"):
    cfg = JAX_CASES["tiny"]
    geo = jpre.crop_geometry(jnp.asarray(boxes), frame.shape[:2])
    x = jpre.normalize_crops(jpre.sample_crops(jnp.asarray(frame), geo, IMAGE_SIZE), dtype)
    hm = jax_forward(params, x, cfg, block_impl=block_impl).astype(jnp.float32)
    if pairs is not None:
        hf = jax_forward(params, x[:, :, ::-1, :], cfg, block_impl=block_impl)
        hm = 0.5 * (hm + jax_flip_back(hf.astype(jnp.float32), pairs))
    return np.asarray(hm)


def test_pose_step_matches_jax_and_reference_keypoints(g, tiny):
    params, model = tiny
    boxes, mask = padded(g["boxes"], bucket_slots(len(g["boxes"])))
    got = pose_step(serving_copy(model, "fp32"), g["frame"], boxes, mask, device="cpu").numpy()
    ref = np.asarray(pose_step_jit(params, jnp.asarray(g["frame"]), jnp.asarray(boxes),
                                   jnp.asarray(mask), JAX_CASES["tiny"]))
    n = len(g["boxes"])
    for other in (ref[:n], g["keypoints"]):
        # the bounds of tests/test_pose_step.py: scores tight; a random-weight
        # model may flip a few tied argmax peaks, so coordinates by fraction
        assert np.abs(got[:n, :, 2] - other[..., 2]).max() < 1e-5
        d = np.abs(got[:n, :, :2] - other[..., :2])
        assert (d.max(-1) < 0.5).mean() >= 0.97
        assert np.percentile(d, 95) < 0.1
    assert np.all(got[n:] == 0)


def test_pose_step_flip_and_masks_fp32(tiny):
    params, model = tiny
    frame, boxes = random_scene(1)
    boxes_p, mask = padded(boxes, 8)
    mask[1] = False                                   # a masked slot in the middle
    fp32 = serving_copy(model, "fp32")
    with torch.no_grad():
        hm, _ = pose_heatmaps(fp32, torch.from_numpy(frame), torch.from_numpy(boxes_p),
                              flip_pairs=PAIRS)
    ref = jax_heatmaps(params, frame, boxes_p, pairs=PAIRS)
    np.testing.assert_allclose(hm.numpy(), ref, atol=2e-5 * np.abs(ref).max())

    got = pose_step(fp32, torch.from_numpy(frame), boxes_p, mask, flip_pairs=PAIRS).numpy()
    want = np.asarray(pose_step_jit(params, jnp.asarray(frame), jnp.asarray(boxes_p),
                                    jnp.asarray(mask), JAX_CASES["tiny"], flip_pairs=PAIRS))
    assert np.all(got[~mask] == 0) and np.isfinite(got).all()
    assert np.abs(got[..., 2] - want[..., 2]).max() < 1e-5
    assert (np.abs(got[..., :2] - want[..., :2]).max(-1) < 0.5).mean() >= 0.97


def test_pose_step_int8_close_to_jax_int8(tiny):
    params, model = tiny
    frame, boxes = random_scene(2)
    boxes_p, mask = padded(boxes, 8)
    q8 = serving_copy(model, "int8")
    with torch.no_grad():
        hm, _ = pose_heatmaps(q8, torch.from_numpy(frame), torch.from_numpy(boxes_p))
    ref = jax_heatmaps(quantize_vit_params(params), frame, boxes_p, dtype=jnp.bfloat16,
                       block_impl="xla_q8")
    f32 = jax_heatmaps(params, frame, boxes_p)
    # the int8 bound of tests/test_quant.py: 0.02 of the f32 heatmap range
    span = np.ptp(f32)
    assert np.abs(hm.numpy() - ref).max() < 0.02 * span
    assert np.abs(hm.numpy() - f32).max() < 0.02 * span
    got = pose_step(q8, frame, boxes_p, mask, device="cpu").numpy()
    want = np.asarray(pose_step_jit(quantize_vit_params(params), jnp.asarray(frame),
                                    jnp.asarray(boxes_p), jnp.asarray(mask), JAX_CASES["tiny"],
                                    compute_dtype=jnp.bfloat16, block_impl="xla_q8"))
    assert np.all(got[~mask] == 0) and np.isfinite(got).all()
    # scores are heatmap maxima: within the same 0.02 of the range
    assert np.abs(got[..., 2] - want[..., 2]).max() < 0.02 * span
    assert np.abs(got[mask, :, 2] - f32.reshape(8, 17, -1).max(-1)[mask]).max() < 0.02 * span


def test_pose_step_runs_on_cuda_unless_asked_for_cpu(g, tiny):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the step would run there")
    _, model = tiny
    boxes, mask = padded(g["boxes"], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        pose_step(model, g["frame"], boxes, mask)              # numpy inputs -> CUDA
    out = pose_step(model, torch.from_numpy(g["frame"]), boxes, mask)   # CPU tensor
    assert out.shape == (8, 17, 3)
    with pytest.raises(ValueError, match="model is on"):
        pose_step(model, g["frame"], boxes, mask, device="meta")


def test_bucket_slots():
    assert [bucket_slots(n) for n in (0, 1, 3, 17, 1000)] == [1, 1, 4, 32, 64]
