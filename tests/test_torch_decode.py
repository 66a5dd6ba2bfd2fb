"""PyTorch port: the UDP decode and the plain version of K4 (modulate) vs the
reference goldens of tests/golden/decode_golden.npz, the JAX decode and the
JAX Pallas modulate kernel in interpret mode.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.ops import decode as jdecode
from easy_vitpose_tpu.ops.pallas_kernels import udp_modulate_pallas
from easy_vitpose_tpu_torch.ops import decode, modulate
from easy_vitpose_tpu_torch.ops.affine import flip_back_heatmaps

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "decode_golden.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gaussian_kernel_matches_jax():
    for k in (11, 17):
        np.testing.assert_array_equal(decode.gaussian_kernel_1d(k), jdecode.gaussian_kernel_1d(k))


def test_get_max_preds_matches_reference(g):
    preds, maxvals = decode.get_max_preds(t(g["heatmaps"]))
    np.testing.assert_array_equal(preds.numpy(), g["preds_argmax"])
    np.testing.assert_array_equal(maxvals.numpy(), g["maxvals"])


def test_blur_matches_jax(g):
    hm = g["heatmaps"][:2]
    np.testing.assert_allclose(decode.gaussian_blur_2d(t(hm), 11).numpy(),
                               np.asarray(jdecode.gaussian_blur_2d(jnp.asarray(hm), 11)),
                               atol=1e-7)


def test_modulate_plain_matches_jax_pallas_kernel(g):
    """K4's plain version vs the Pallas modulate (interpret mode): the same
    taps summed in the same order, then clip and log."""
    hm = g["heatmaps"][:2]
    ref = np.asarray(udp_modulate_pallas(jnp.asarray(hm), 11, interpret=True))
    got = modulate.udp_modulate(t(hm), 11).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("kernel,key", [(11, "preds_udp"), (17, "preds_udp_k17")])
def test_post_dark_udp_matches_reference_and_jax(g, kernel, key):
    preds, _ = decode.get_max_preds(t(g["heatmaps"]))
    got = decode.post_dark_udp(preds, t(g["heatmaps"]), kernel=kernel).numpy()
    # the reference bound of tests/test_decode.py (log near the clip floor)
    np.testing.assert_allclose(got, g[key], atol=2e-2)
    jp, _ = jdecode.get_max_preds(jnp.asarray(g["heatmaps"]))
    ref = np.asarray(jdecode.post_dark_udp(jp, jnp.asarray(g["heatmaps"]), kernel=kernel))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_post_dark_udp_wraps_across_maps_like_jax():
    """Border peaks and -1 coordinates read the neighbouring map through the
    global flatten with wrap-around (decode.py:100-120), as in JAX."""
    rng = np.random.default_rng(4)
    hm = rng.uniform(0.0, 1.0, (3, 4, 16, 12)).astype(np.float32)
    coords = np.zeros((3, 4, 2), np.float32)
    coords[0, 0] = [0, 0]          # top-left corner
    coords[1, 2] = [11, 15]        # bottom-right corner
    coords[2, 3] = [-1, -1]        # "no peak": reads the previous map
    coords[0, 1] = [11, 0]
    coords[2, 0] = [5, 7]
    got = decode.post_dark_udp(t(coords), t(hm), kernel=5).numpy()
    ref = np.asarray(jdecode.post_dark_udp(jnp.asarray(coords), jnp.asarray(hm), kernel=5))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_full_udp_decode_matches_reference(g):
    preds, maxvals = decode.keypoints_from_heatmaps_udp(
        t(g["heatmaps"]), t(g["centers"]), t(g["scales"]), kernel=11)
    np.testing.assert_allclose(preds.numpy(), g["preds_full"], atol=0.1)
    np.testing.assert_array_equal(maxvals.numpy(), g["maxvals_full"])


def test_flip_back_matches_jax():
    from easy_vitpose_tpu.ops.affine import flip_back_heatmaps as jflip
    hm = np.random.default_rng(5).standard_normal((2, 17, 8, 6)).astype(np.float32)
    pairs = ((1, 2), (3, 4), (5, 6), (15, 16))
    np.testing.assert_array_equal(flip_back_heatmaps(t(hm), pairs).numpy(),
                                  np.asarray(jflip(jnp.asarray(hm), pairs)))
