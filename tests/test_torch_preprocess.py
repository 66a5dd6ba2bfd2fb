"""PyTorch port: crop geometry, the plain crop sampler and the plain
version of K3 (sampler + normalize) vs the JAX package's gather sampler, its
Pallas sampler in interpret mode, and the reference crops of
tests/golden/pipeline_golden.npz.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import IMAGE_SIZE
from easy_vitpose_tpu.ops import preprocess as jpre
from easy_vitpose_tpu.ops.pallas_sampler import sample_crops_pallas
from easy_vitpose_tpu_torch.ops import preprocess, sampler

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipeline_golden.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def awkward_boxes(H, W):
    """.5 corners (banker's rounding), edge-touching, 1-px, outside, wide."""
    return np.array([[10.5, 20.5, 60.5, 90.5], [11.5, 21.5, 61.5, 91.5],
                     [-30.0, -40.0, 120.0, 150.0], [W - 80.0, H - 60.0, W + 20.0, H + 5.0],
                     [100.5, 80.5, 101.5, 81.5], [W + 50.0, H + 50.0, W + 90.0, H + 80.0],
                     [5.0, 100.0, W - 5.0, 130.0], [40.0, 5.0, 70.0, H - 5.0]], np.float32)


def test_crop_geometry_matches_jax():
    H, W = 240, 320
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20, 300, (40, 2))
    wh = rng.uniform(1, 200, (40, 2))
    boxes = np.concatenate([awkward_boxes(H, W),
                            np.concatenate([xy, xy + wh], 1).astype(np.float32)])
    got = preprocess.crop_geometry(torch.from_numpy(boxes), (H, W))
    ref = jpre.crop_geometry(jnp.asarray(boxes), (H, W))
    for k in preprocess.GEO_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # banker's rounding: 10.5 -> 10 and 11.5 -> 12, both then minus the 10 px pad
    assert got["x1"][0] == 0 and got["x1"][1] == 2


def test_sample_crops_matches_jax_and_reference(g):
    frame, boxes = g["frame"], g["boxes"]
    geo = preprocess.crop_geometry(torch.from_numpy(boxes), frame.shape[:2])
    got = preprocess.sample_crops(torch.from_numpy(frame), geo).numpy()
    jgeo = jpre.crop_geometry(jnp.asarray(boxes), frame.shape[:2])
    ref = np.asarray(jpre.sample_crops(jnp.asarray(frame), jgeo, IMAGE_SIZE))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # the reference's own crop -> pad -> cv2 uint8 resize (test_pose_step's bound)
    d = np.abs(got / 255.0 - g["crops"])
    assert d.max() < 3.5 / 255.0 and d.mean() < 0.5 / 255.0


def test_sampler_plain_matches_jax_pallas_sampler():
    """K3's plain version vs the Pallas sampler (interpret) + normalize, at
    float32, on edge, 1-px and outside boxes of a frame whose height is not
    a multiple of the sampler's window."""
    H, W = 200, 256
    frame = np.random.default_rng(1).integers(0, 256, (H, W, 3), dtype=np.uint8)
    boxes = awkward_boxes(H, W)
    geo = preprocess.crop_geometry(torch.from_numpy(boxes), (H, W))
    got = sampler.sample_normalize(torch.from_numpy(frame), geo).numpy()
    jgeo = jpre.crop_geometry(jnp.asarray(boxes), (H, W))
    crops = sample_crops_pallas(jnp.asarray(frame), jgeo, IMAGE_SIZE,
                                sample_dtype=jnp.float32, interpret=True)
    ref = np.asarray(jpre.normalize_crops(crops))
    # A box wholly below the frame has y1 == H: the gather sampler (the
    # port's contract) clamps its row to H - 1, the Pallas sampler reads
    # the zero rows of its padded window.  That crop is held to the gather.
    below = np.asarray(jgeo["y1"]) >= H
    assert below.sum() == 1
    np.testing.assert_allclose(got[~below], ref[~below], atol=1e-4)
    gather = np.asarray(jpre.normalize_crops(jpre.sample_crops(jnp.asarray(frame), jgeo,
                                                               IMAGE_SIZE)))
    np.testing.assert_allclose(got[below], gather[below], atol=1e-4)


def test_sampler_bf16_rounds_once(g):
    """The port rounds the normalized crop to bf16 once; the JAX bf16 gather
    rounds after each lerp pass.  Both stay within a few 1/255 levels."""
    frame, boxes = g["frame"], g["boxes"]
    geo = preprocess.crop_geometry(torch.from_numpy(boxes), frame.shape[:2])
    f32 = sampler.sample_normalize(torch.from_numpy(frame), geo).numpy()
    b16 = sampler.sample_normalize(torch.from_numpy(frame), geo,
                                   dtype=torch.bfloat16).float().numpy()
    # one bf16 rounding of values up to |2.7|: half an ulp, 2^-8 of the value
    assert np.all(np.abs(b16 - f32) <= np.abs(f32) * 2.0 ** -8 + 1e-6)
    jgeo = jpre.crop_geometry(jnp.asarray(boxes), frame.shape[:2])
    jb16 = np.asarray(jpre.normalize_crops(
        jpre.sample_crops(jnp.asarray(frame), jgeo, IMAGE_SIZE, sample_dtype=jnp.bfloat16),
        jnp.bfloat16), np.float32)
    level = 1.0 / (255.0 * 0.225)          # one 1/255 step, normalized
    assert np.abs(b16 - jb16).max() < 3.0 * level


def test_normalize_matches_jax():
    crops = np.random.default_rng(2).uniform(0, 255, (2, 8, 6, 3)).astype(np.float32)
    got = preprocess.normalize_crops(torch.from_numpy(crops)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpre.normalize_crops(jnp.asarray(crops))))
