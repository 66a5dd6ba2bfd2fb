"""PyTorch port: the stacked-frame sampler and pose step (K3's plain
version with a frame index per box, ``pose_step(frame_idx=)``,
``pose_multi_frame``) against the JAX package's ``sample_crops(frame_idx=)``
and ``pipeline/stream.py::_pose_multi_frame``, on the CPU, where every
wrapper takes its plain version.

Tolerances: crops as tests/test_torch_preprocess.py (1e-4 at float32, bit
for bit at bf16); a stacked crop equals the same box's crop from its own
frame bit for bit (the same gather); keypoints as
tests/test_torch_pose_step.py (scores within 1e-5, coordinates within 0.5
px except at most 2 of a person's 17, whose tied peaks a random-weight
model may flip, median within 0.01 px); the stacked pose step against the
per-frame one within 1e-4 (the backbone's batch differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import IMAGE_SIZE
from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict
from easy_vitpose_tpu.ops import preprocess as jpre
from easy_vitpose_tpu.pipeline.stream import _pose_multi_frame
from easy_vitpose_tpu_torch.models.vitpose import serving_copy
from easy_vitpose_tpu_torch.ops import preprocess, sampler
from easy_vitpose_tpu_torch.pipeline.pose_step import pose_multi_frame, pose_step
from tests.test_model_parity import CASES as JAX_CASES
from tests.test_model_parity import load_case
from tests.test_torch_model import port_model
from tests.test_torch_preprocess import awkward_boxes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    sd, _, _ = load_case("tiny")
    params = convert_vitpose_state_dict(sd, JAX_CASES["tiny"])
    return params, serving_copy(port_model(params, "tiny"), "fp32")


def stack(S=3, H=120, W=160, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (S, H, W, 3), dtype=np.uint8)


def boxes_and_index(H, W, S, seed=0):
    """The awkward boxes and random ones, each on a frame of the stack."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, W, (8, 2))
    wh = rng.uniform(2, 120, (8, 2))
    boxes = np.concatenate([awkward_boxes(H, W),
                            np.concatenate([xy, xy + wh], 1).astype(np.float32)])
    return boxes, rng.integers(0, S, len(boxes)).astype(np.int32)


def jax_crops(frames, boxes, fidx, dtype):
    geo = jpre.crop_geometry(jnp.asarray(boxes), frames.shape[1:3])
    crops = jpre.sample_crops(jnp.asarray(frames), geo, IMAGE_SIZE, sample_dtype=dtype,
                              frame_idx=jnp.asarray(fidx))
    return np.asarray(jpre.normalize_crops(crops, dtype), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_crops_frame_idx_matches_jax(dtype):
    frames = stack()
    boxes, fidx = boxes_and_index(*frames.shape[1:3], len(frames))
    got, _ = sampler.crop_normalize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                    dtype=getattr(torch, dtype), frame_idx=torch.from_numpy(fidx))
    ref = jax_crops(frames, boxes, fidx, getattr(jnp, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("hw", [(120, 160), (37, 53)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_equals_per_frame(hw, dtype):
    """Each stacked crop is its own frame's crop, bit for bit, with the same
    packed geometry; (37, 53) makes H * W * 3 odd, so the frames of the
    stack after the first start off a word boundary."""
    H, W = hw
    assert H * W * 3 % 2 == 1 or hw == (120, 160)
    frames = stack(4, H, W, seed=1)
    boxes, fidx = boxes_and_index(H, W, 4, seed=1)
    got, geo = sampler.crop_normalize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                      dtype=dtype, frame_idx=torch.from_numpy(fidx))
    for i in range(len(boxes)):
        one, g1 = sampler.crop_normalize(torch.from_numpy(frames[fidx[i]]),
                                         torch.from_numpy(boxes[i:i + 1]), dtype=dtype)
        assert torch.equal(got[i:i + 1], one), i
        assert torch.equal(geo[i:i + 1], g1), i


def test_clamped_frame_indices():
    """Out-of-range indices are taken as JAX's gather takes them: a
    negative one counts from the end, the rest clamp to [0, S - 1]."""
    frames = stack(3, seed=2)
    boxes, _ = boxes_and_index(*frames.shape[1:3], 3, seed=2)
    boxes = boxes[:6]
    fidx = np.array([-1, 5, -7, 0, 2, -3], np.int32)
    want = np.array([2, 2, 0, 0, 2, 0])
    np.testing.assert_array_equal(
        preprocess.clamp_frame_idx(torch.from_numpy(fidx), 3).numpy(), want)
    got, _ = sampler.crop_normalize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                    frame_idx=torch.from_numpy(fidx))
    np.testing.assert_allclose(got.numpy(), jax_crops(frames, boxes, fidx, jnp.float32),
                               atol=1e-4)
    same, _ = sampler.crop_normalize(torch.from_numpy(frames), torch.from_numpy(boxes),
                                     frame_idx=torch.from_numpy(want.astype(np.int32)))
    assert torch.equal(got, same)


def scene(S=2, H=192, W=256):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for seed in range(S):
        f = np.stack([np.sin(xx / (11 + 3 * seed)), np.cos(yy / (13 + seed)),
                      np.sin((xx + yy) / (17 + seed))], -1)
        out.append(((f - f.min()) / (np.ptp(f) + 1e-9) * 255).astype(np.uint8))
    return np.stack(out)


def assert_keypoints_close(got, ref):
    assert np.abs(got[..., 2] - ref[..., 2]).max() < 1e-5
    d = np.abs(got[..., :2] - ref[..., :2]).max(-1)
    assert (d >= 0.5).sum(-1).max() <= 2 and np.median(d) < 0.01


def test_pose_multi_frame_matches_jax_and_per_frame(tiny):
    """tests/test_multistream.py::test_multiframe_matches_per_frame, and the
    port's stacked step against JAX's on the same stack."""
    params, model = tiny
    frames = scene()
    boxes = np.array([[30, 20, 120, 170], [100, 10, 240, 180], [5, 5, 80, 150],
                      [0, 0, 0, 0]], np.float32)
    fidx = np.array([0, 1, 1, 0], np.int32)
    mask = np.array([True, True, True, False])
    got = pose_multi_frame(model, frames, boxes, fidx, mask, device="cpu").numpy()
    ref = np.asarray(_pose_multi_frame(params, jnp.asarray(frames), jnp.asarray(boxes),
                                       jnp.asarray(fidx), jnp.asarray(mask), JAX_CASES["tiny"],
                                       compute_dtype=jnp.float32))
    assert got.shape == (4, 17, 3) and (got[3] == 0).all()
    assert_keypoints_close(got[:3], ref[:3])
    for i in range(3):
        one = pose_step(model, frames[fidx[i]], boxes[i:i + 1], np.array([True]),
                        device="cpu").numpy()
        np.testing.assert_allclose(got[i], one[0], atol=1e-4)
