"""PyTorch port: the library remainder against the JAX package, on the CPU.

* ``ops/decode.py``: the front door ``keypoints_from_heatmaps`` in each of
  JAX's modes (default, megvii, unbiased/DARK, None, UDP, and UDP with
  ``use_pallas``, which runs JAX's Pallas K4 in interpret mode and the
  port's full-map K4 wrapper, whose CPU route is its plain version), its
  parts (``default_shift_decode``, ``modulate_gaussian_blur``,
  ``taylor_refine``), the 3D and regression decodes; maps with tied
  peaks, a border peak and no positive value.  Coordinates within 1e-4
  px, scores bit for bit.
* ``train/losses.py`` and ``train/mesh_losses.py``: every loss against
  JAX's on the same inputs, within 1e-6 of its value.
* ``ops/group.py``: peak NMS and top-k (with tied values) equal, and the
  same groups from ``parse_bottom_up``.
* ``native/``: the port's ``nms_cpu``, built here from ``native/nms.cpp``,
  equal to its plain version (``ops/oks.py::bbox_nms``) and to JAX's
  ``nms_cpu`` on random boxes.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.ops import decode as jd
from easy_vitpose_tpu.ops import group as jg
from easy_vitpose_tpu.train import losses as jl
from easy_vitpose_tpu.train import mesh_losses as jm
from easy_vitpose_tpu_torch.ops import decode as pd
from easy_vitpose_tpu_torch.ops import group as pg
from easy_vitpose_tpu_torch.train import losses as pl
from easy_vitpose_tpu_torch.train import mesh_losses as pm

torch.set_num_threads(2)
COORD_TOL, LOSS_TOL = 1e-4, 1e-6


def T(a):
    return torch.from_numpy(np.asarray(a))


def blobs(rng, N, K, H, W):
    """Gaussian peaks at random sub-pixel places on noise, with the cases
    that decide a decode: two equal peaks (the first must win), a peak on
    the border, a map with no positive value and an all-zero map."""
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = rng.uniform(2, H - 3, (N, K, 1, 1)), rng.uniform(2, W - 3, (N, K, 1, 1))
    hm = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0 ** 2))
    hm = (hm + 0.01 * rng.uniform(size=hm.shape)).astype(np.float32)
    hm[0, 0] = 0.1
    hm[0, 0, 10, 7] = hm[0, 0, 30, 20] = 0.9                         # tied peaks
    hm[0, 1] = 0.05
    hm[0, 1, 0, W - 1] = 1.0                                         # border peak
    hm[1, 0] = -np.abs(hm[1, 0])                                     # no positive value
    hm[1, 1] = 0.0
    return hm


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    N, K = 3, 4
    hm = blobs(rng, N, K, 64, 48)
    center = rng.uniform(100, 400, (N, 2)).astype(np.float32)
    scale = rng.uniform(80, 240, (N, 2)).astype(np.float32)
    return hm, center, scale


MODES = {"default": dict(post_process="default"), "megvii": dict(post_process="megvii"),
         "unbiased": dict(unbiased=True), "none": dict(post_process=None),
         "udp": dict(use_udp=True), "udp_pallas": dict(use_udp=True, use_pallas=True)}


@pytest.mark.parametrize("mode", MODES)
def test_keypoints_from_heatmaps_matches_jax(maps, mode, monkeypatch):
    hm, center, scale = maps
    if mode == "udp_pallas":
        from easy_vitpose_tpu.ops import pallas_kernels
        monkeypatch.setattr(pallas_kernels, "udp_modulate_pallas", functools.partial(
            pallas_kernels.udp_modulate_pallas, interpret=True))
    jp, jv = jd.keypoints_from_heatmaps(jnp.asarray(hm), jnp.asarray(center),
                                        jnp.asarray(scale), **MODES[mode])
    pp, pv = pd.keypoints_from_heatmaps(T(hm), T(center), T(scale), **MODES[mode])
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=COORD_TOL)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_ties_border_and_no_peak(maps):
    """The first of two equal maxima (as ``jnp.argmax``), a border peak, and
    -1 where no value is positive, in both frameworks."""
    hm = maps[0]
    jp, _ = jd.get_max_preds(jnp.asarray(hm))
    pp, _ = pd.get_max_preds(T(hm))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert pp[0, 0].tolist() == [7.0, 10.0] and pp[0, 1].tolist() == [47.0, 0.0]
    assert pp[1, 0].tolist() == [-1.0, -1.0] and pp[1, 1].tolist() == [-1.0, -1.0]


def test_decode_parts_match_jax(maps):
    hm = maps[0]
    jo, jv, jgate = jd.default_shift_decode(jnp.asarray(hm), return_gate=True)
    po, pv, pgate = pd.default_shift_decode(T(hm), return_gate=True)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pgate.numpy(), np.asarray(jgate))
    jb = np.asarray(jd.modulate_gaussian_blur(jnp.asarray(hm), 11))
    pb = pd.modulate_gaussian_blur(T(hm), 11).numpy()
    np.testing.assert_allclose(pb, jb, rtol=1e-6, atol=1e-7)
    logm = np.log(np.maximum(np.abs(jb), 1e-10)).astype(np.float32)
    coords, _ = pd.get_max_preds(T(hm))
    jt = np.asarray(jd.taylor_refine(jnp.asarray(logm), jnp.asarray(coords.numpy())))
    np.testing.assert_allclose(pd.taylor_refine(T(logm), coords).numpy(), jt, atol=COORD_TOL)


def test_3d_and_regression_decodes_match_jax(maps):
    rng = np.random.default_rng(1)
    _, center, scale = maps
    h3 = rng.normal(size=(3, 4, 5, 16, 12)).astype(np.float32)
    h3[0, 0] = -1.0                                                  # no positive value
    h3[0, 1] = 0.0
    h3[0, 1, 2, 3, 4] = h3[0, 1, 4, 3, 4] = 1.0                      # tied along z
    jp, jv = jd.keypoints_from_heatmaps3d(jnp.asarray(h3), jnp.asarray(center),
                                          jnp.asarray(scale))
    pp, pv = pd.keypoints_from_heatmaps3d(T(h3), T(center), T(scale))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=COORD_TOL)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    reg = rng.uniform(0, 1, (3, 4, 2)).astype(np.float32)
    jp, jv = jd.keypoints_from_regression(jnp.asarray(reg), jnp.asarray(center),
                                          jnp.asarray(scale), (192, 256))
    pp, pv = pd.keypoints_from_regression(T(reg), T(center), T(scale), (192, 256))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=COORD_TOL)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-12), (got, want)


def loss_cases(rng):
    B, K = 3, 6
    hm = rng.uniform(0, 1, (B, K, 16, 12)).astype(np.float32)
    hm_t = rng.uniform(0, 1, (B, K, 16, 12)).astype(np.float32)
    w = (rng.uniform(size=(B, K, 1)) > 0.3).astype(np.float32)
    ct = rng.uniform(0, 1, (B, 3 * K, 16, 12)).astype(np.float32)
    ct_t = rng.uniform(0, 1, (B, 3 * K, 16, 12)).astype(np.float32)
    reg = rng.normal(0, 3, (B, K, 2)).astype(np.float32)
    reg_t = rng.normal(0, 3, (B, K, 2)).astype(np.float32)
    rw = rng.uniform(0, 1, (B, K, 2)).astype(np.float32)
    p3 = rng.normal(size=(B, K, 3)).astype(np.float32)
    t3 = rng.normal(size=(B, K, 3)).astype(np.float32)
    parents = [0, 0, 1, 2, 0, 4]
    logits = rng.normal(0, 3, (B, K)).astype(np.float32)
    labels = (rng.uniform(size=(B, K)) > 0.5).astype(np.float32)
    return {
        "joints_ohkm_mse_loss": ((hm, hm_t, w), dict(topk=4)),
        "combined_target_mse_loss": ((ct, ct_t, w), {}),
        "adaptive_wing_loss": ((hm, hm_t, w), {}),
        "smooth_l1_loss": ((reg, reg_t, rw), {}),
        "l1_loss": ((reg, reg_t, rw), dict(loss_weight=0.5)),
        "mse_regression_loss": ((reg, reg_t, rw), {}),
        "wing_loss": ((reg, reg_t, rw), {}),
        "soft_wing_loss": ((reg, reg_t, rw), {}),
        "bone_loss": ((p3, t3, parents), {}),
        "bce_loss": ((logits, labels, labels * 0.5 + 0.25), {}),
        "mpjpe_loss": ((p3, t3, np.abs(p3)), {}),
    }


@pytest.mark.parametrize("name", list(loss_cases(np.random.default_rng(0))))
def test_loss_matches_jax(name):
    args, kw = loss_cases(np.random.default_rng(2))[name]
    want = getattr(jl, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                               for a in args), **kw)
    got = getattr(pl, name)(*(T(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    close(got, want)


def test_structured_losses_match_jax():
    """The semi-supervision pair (both intrinsics forms), the bottom-up
    heatmap loss and the associative-embedding pull and push."""
    rng = np.random.default_rng(3)
    B, K = 2, 5
    lab, unl = rng.normal(size=(B, K, 3)), rng.normal(size=(B, K, 3))
    traj = np.concatenate([np.zeros((B, 1, 2)), rng.uniform(4, 6, (B, 1, 1))], -1)
    tgt = rng.normal(size=(B, K, 2))
    for intr in (rng.uniform(0.5, 1.5, (B, 4)), rng.uniform(-0.1, 1.5, (B, 9))):
        args = [a.astype(np.float32) for a in (lab, unl, traj, tgt, intr)]
        want = jl.semi_supervision_loss(*map(jnp.asarray, args), [0, 0, 1, 2, 3])
        got = pl.semi_supervision_loss(*map(T, args), [0, 0, 1, 2, 3])
        for k in want:
            close(got[k], want[k])
    hm, hm_t = rng.uniform(size=(2, 3, 8, 8)), rng.uniform(size=(2, 3, 8, 8))
    mask = (rng.uniform(size=(2, 8, 8)) > 0.2)
    np.testing.assert_allclose(
        pl.ae_heatmap_loss(T(hm.astype(np.float32)), T(hm_t.astype(np.float32)), T(mask)).numpy(),
        np.asarray(jl.ae_heatmap_loss(jnp.asarray(hm, jnp.float32), jnp.asarray(hm_t, jnp.float32),
                                      jnp.asarray(mask))), rtol=LOSS_TOL)
    tags = rng.normal(size=(64, 2)).astype(np.float32)
    idx = rng.integers(0, 64, (3, K)).astype(np.int64)
    valid = (rng.uniform(size=(3, K)) > 0.3).astype(np.float32)
    valid[2] = 0                                                     # a person with no joint
    for t in (tags, tags[:, 0]):
        want = jl.ae_grouping_loss(jnp.asarray(t), jnp.asarray(idx), jnp.asarray(valid))
        got = pl.ae_grouping_loss(T(t), T(idx), T(valid))
        for a, b in zip(got, want):
            close(a, b)


def test_mesh_losses_match_jax():
    rng = np.random.default_rng(4)
    B, V, J = 2, 10, 6
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    for fn, arg in ((pm.rot6d_to_rotmat, f(B, 6)), (pm.quat_to_rotmat, f(B, 4)),
                    (pm.batch_rodrigues, f(B, 3))):
        want = np.asarray(getattr(jm, fn.__name__)(jnp.asarray(arg)))
        np.testing.assert_allclose(fn(T(arg)).numpy(), want, rtol=1e-5, atol=1e-6)
    pts, rot, trans = f(B, V, 3), f(B, 3, 3), np.abs(f(B, 3)) + np.array([0, 0, 5], np.float32)
    cc = f(B, 2)
    np.testing.assert_allclose(
        pm.perspective_projection(T(pts), T(rot), T(trans), 500.0, T(cc)).numpy(),
        np.asarray(jm.perspective_projection(jnp.asarray(pts), jnp.asarray(rot),
                                             jnp.asarray(trans), 500.0, jnp.asarray(cc))),
        rtol=1e-5)
    output = {"vertices": f(B, V, 3), "joints_3d": f(B, J, 3),
              "camera": np.abs(f(B, 3)) + np.array([0.5, 0, 0], np.float32),
              "pose": f(B, 24, 3, 3), "beta": f(B, 10)}
    target = {"vertices": f(B, V, 3), "joints_3d": f(B, J, 3),
              "joints_3d_visible": (rng.uniform(size=(B, J, 1)) > 0.3).astype(np.float32),
              "joints_2d": rng.uniform(0, 224, (B, J, 2)).astype(np.float32),
              "joints_2d_visible": (rng.uniform(size=(B, J, 1)) > 0.3).astype(np.float32),
              "pose": f(B, 72), "beta": f(B, 10), "has_smpl": np.array([1.0, 0.0], np.float32)}
    want = jm.mesh_loss({k: jnp.asarray(v) for k, v in output.items()},
                        {k: jnp.asarray(v) for k, v in target.items()}, vertex_loss_weight=2.0)
    got = pm.mesh_loss({k: T(v) for k, v in output.items()},
                       {k: T(v) for k, v in target.items()}, vertex_loss_weight=2.0)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    x = f(3, 4)
    for gan_type in ("vanilla", "lsgan", "wgan", "hinge"):
        for real in (True, False):
            for disc in (True, False):
                close(pm.gan_loss(T(x), real, gan_type, loss_weight=0.3, is_disc=disc),
                      jm.gan_loss(jnp.asarray(x), real, gan_type, loss_weight=0.3, is_disc=disc))


def test_grouping_matches_jax():
    """Peak NMS, top-k with tied values (lower flat index first, as
    ``lax.top_k``) and the whole bottom-up parse of two people give JAX's
    values and groups."""
    rng = np.random.default_rng(5)
    K, H, W = 4, 32, 24
    yy, xx = np.mgrid[0:H, 0:W]
    hm = np.zeros((K, H, W), np.float32)
    tags = np.zeros((K, H, W), np.float32)
    for tag, (cy, cx) in ((0.0, (8, 6)), (3.0, (22, 17))):
        for j in range(K):
            py, px = cy + rng.integers(-2, 3), cx + rng.integers(-2, 3)
            hm[j] = np.maximum(hm[j], np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / 4.0))
            tags[j, max(py - 3, 0):py + 4, max(px - 3, 0):px + 4] = tag + 0.05 * j
    hm[3, 0:2, 0:2] = 0.5                                            # a plateau: tied peaks
    want = np.asarray(jg.heatmap_peak_nms(jnp.asarray(hm)[None]))
    got = pg.heatmap_peak_nms(T(hm)[None])
    np.testing.assert_array_equal(got.numpy(), want)
    jc = jg.top_k_candidates(jnp.asarray(want[0]), jnp.asarray(tags), k=6)
    pc = pg.top_k_candidates(got[0], T(tags), k=6)
    for k in ("loc", "val", "tag"):
        np.testing.assert_array_equal(pc[k], jc[k])
    want = jg.parse_bottom_up(hm, tags, top_k=6)
    got = pg.parse_bottom_up(hm, tags, top_k=6)
    assert got.shape == want.shape and got.shape[0] >= 2
    np.testing.assert_array_equal(got, want)


def test_native_nms_matches_plain_and_jax():
    from easy_vitpose_tpu.native import nms_cpu as jax_nms
    from easy_vitpose_tpu_torch.native import library_path, nms_cpu
    from easy_vitpose_tpu_torch.ops.oks import bbox_nms

    rng = np.random.default_rng(6)
    for n, thr in ((0, 0.5), (1, 0.5), (60, 0.3), (200, 0.5), (200, 0.7)):
        xy = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(5, 60, (n, 2))
        dets = np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
        got = nms_cpu(dets, thr)
        assert got == bbox_nms(dets, thr) == jax_nms(dets, thr), (n, thr)
    assert library_path().exists()
