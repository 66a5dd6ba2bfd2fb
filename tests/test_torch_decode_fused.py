"""PyTorch port: the plain versions of the fused decode (``decode.cu``) and of
the crop kernel's geometry output (``sampler.cu``), on the CPU.

* ``modulate_at_plain`` (the decode kernel's pointwise modulate) is
  ``udp_modulate_plain`` (the full-map K4's plain version) bit for bit at
  every position, and at the seven points ``newton_point_index`` gives it is
  the flat take of the edge-padded batch that ``post_dark_udp`` reads;
* ``decode_keypoints_plain`` (argmax, Newton step, UDP transform, un-crop,
  mask) against JAX's ``keypoints_from_heatmaps_udp`` and the JAX pose
  step's un-crop, on maps with no peak (the wrap-around, map 0 included),
  peaks on every border, tied maxima and masked slots;
* the packed geometry of ``crop_normalize`` against ``crop_geometry`` and
  JAX's on ``chip_smoke.make_boxes``' awkward boxes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import decode_maps, make_boxes
from easy_vitpose_tpu.ops import decode as jdecode
from easy_vitpose_tpu.ops import preprocess as jpre
from easy_vitpose_tpu_torch.ops import decode, modulate, preprocess, sampler

torch.set_num_threads(1)
FRAME_HW = (1080, 1920)
POSE_MAPS = (64, 17, 64, 48)       # the pose step's heatmaps at 64 slots


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_decode(hm, boxes, mask, kernel):
    """JAX's UDP decode and the JAX pose step's un-crop
    (``easy_vitpose_tpu/pipeline/pose_step.py``)."""
    g = jpre.crop_geometry(jnp.asarray(boxes), FRAME_HW)
    center = jnp.stack([g["wp"] // 2, g["hp"] // 2], -1).astype(jnp.float32)
    scale = jnp.stack([g["wp"], g["hp"]], -1).astype(jnp.float32)
    preds, maxvals = jdecode.keypoints_from_heatmaps_udp(jnp.asarray(hm), center, scale,
                                                         kernel=kernel)
    xk = preds[..., 0] + (g["x1"] - g["left"]).astype(jnp.float32)[:, None]
    yk = preds[..., 1] + (g["y1"] - g["top"]).astype(jnp.float32)[:, None]
    kpts = jnp.stack([yk, xk, maxvals[..., 0]], axis=-1)
    return np.asarray(kpts * jnp.asarray(mask)[:, None, None].astype(jnp.float32)), g


@pytest.mark.parametrize("kernel", [11, 17])
@pytest.mark.parametrize("shape", [(2, 3, 20, 15), (2,) + POSE_MAPS[1:]])
def test_modulate_at_plain_is_udp_modulate_plain_bit_for_bit(shape, kernel):
    hm = t(np.random.default_rng(kernel).standard_normal(shape).astype(np.float32) * 0.3 + 0.2)
    full = modulate.udp_modulate_plain(hm, kernel).reshape(-1)
    got = modulate.modulate_at_plain(hm, torch.arange(full.numel()), kernel)
    assert torch.equal(got.view(torch.int32), full.view(torch.int32))


@pytest.mark.parametrize("kernel", [11, 17])
def test_newton_points_are_post_dark_udps_flat_take(kernel):
    """At the pose step's shapes: the seven values the Newton step reads
    from the edge-padded, batch-flattened maps (with wrap-around) are the
    pointwise modulate at ``newton_point_index``, bit for bit."""
    rng = np.random.default_rng(1)
    hm = t(decode_maps(rng, *POSE_MAPS))
    N, K, H, W = hm.shape
    coords, _ = decode.get_max_preds(hm)
    assert (coords[0, :3] == -1).all()
    padded = F.pad(modulate.udp_modulate_plain(hm, kernel), (1, 1, 1, 1),
                   mode="replicate").reshape(-1)
    base = ((coords[..., 0].long() + 1) + (coords[..., 1].long() + 1) * (W + 2)
            + (H + 2) * (W + 2) * torch.arange(N * K).reshape(N, K))
    offsets = torch.tensor([0, 1, W + 2, W + 3, -(W + 3), -1, -(W + 2)])
    want = padded[(base[..., None] + offsets) % padded.numel()]
    got = modulate.modulate_at_plain(hm, decode.newton_point_index(coords, H, W), kernel)
    assert torch.equal(got, want)
    # map 0 has no peak: its "previous map" reads are the last map's
    last = N * K - 1
    idx = decode.newton_point_index(coords, H, W)
    assert (idx[0, 0, 4:] // (H * W) == last).all() and (idx[0, 0, :4] // (H * W) == 0).all()


@pytest.mark.parametrize("kernel", [11, 17])
@pytest.mark.parametrize("M", [POSE_MAPS[0], 5])
def test_decode_keypoints_plain_matches_jax(M, kernel):
    """Scores are the same bits (the same maxima); coordinates within
    test_torch_decode.py's 1e-4 heatmap px of JAX's Newton step, carried to
    the frame by the UDP scale, plus two ulps for the final adds."""
    rng = np.random.default_rng(M + kernel)
    K, H, W = POSE_MAPS[1:]
    hm = decode_maps(rng, M, K, H, W)
    boxes = make_boxes(rng, M, *FRAME_HW)
    mask = np.arange(M) != M - 2
    geo = preprocess.pack_geometry(preprocess.crop_geometry(t(boxes), FRAME_HW))
    got = decode.decode_keypoints_plain(t(hm), geo, t(mask), kernel).numpy()
    ref, g = jax_decode(hm, boxes, mask, kernel)
    assert got.shape == (M, K, 3) and np.isfinite(got).all()
    assert np.all(got[~mask] == 0)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    scale = np.stack([np.asarray(g["hp"]) / (H - 1), np.asarray(g["wp"]) / (W - 1)], -1)
    tol = 1e-4 * scale[:, None, :] + 2 * np.spacing(np.abs(ref[..., :2]))
    assert np.all(np.abs(got[..., :2] - ref[..., :2]) <= tol)
    # the no-peak maps decode at the -1 coordinate plus their Newton offset
    assert got[0, 0, 2] < 0 and (got[0, 1:3, 2] == 0).all()


def test_decode_keypoints_cpu_is_plain_and_points_are_the_full_maps(monkeypatch):
    rng = np.random.default_rng(7)
    hm = t(decode_maps(rng, 4))
    boxes = t(make_boxes(rng, 4, *FRAME_HW))
    geo = preprocess.pack_geometry(preprocess.crop_geometry(boxes, FRAME_HW))
    mask = t(np.array([True, True, False, True]))
    calls, plain = [], decode.decode_keypoints_plain
    monkeypatch.setattr(decode, "decode_keypoints_plain",
                        lambda *a: calls.append(a) or plain(*a))
    kpts, pts = decode.decode_keypoints(hm, geo, mask, with_points=True)
    assert len(calls) == 1 and calls[0][0] is hm and kpts.shape == (4, 17, 3)
    coords, _ = decode.get_max_preds(hm)
    full = modulate.udp_modulate_plain(hm).reshape(-1)
    want = full[decode.newton_point_index(coords, 64, 48)]
    assert torch.equal(pts[mask], want[mask]) and (pts[~mask] == 0).all()
    # bf16 heatmaps decode as their float32 widening
    hb = hm.bfloat16()
    assert torch.equal(decode.decode_keypoints(hb, geo, mask),
                       plain(hb.float(), geo, mask))


def test_packed_geometry_matches_crop_geometry_and_jax():
    """The geometry rows the crop kernel writes (its plain version on the
    CPU), on the smoke's boxes: .5 corners (banker's rounding), past the
    top-left edge, at the bottom-right edge, wholly outside, wide."""
    H, W = FRAME_HW
    boxes = make_boxes(np.random.default_rng(0), 64, H, W)
    packed = preprocess.pack_geometry(preprocess.crop_geometry(t(boxes), FRAME_HW))
    views = preprocess.geometry_views(packed)
    jgeo = jpre.crop_geometry(jnp.asarray(boxes), FRAME_HW)
    for i, k in enumerate(preprocess.GEO_KEYS):
        np.testing.assert_array_equal(views[k].numpy(), np.asarray(jgeo[k]), err_msg=k)
        assert views[k].data_ptr() == packed.data_ptr() + 4 * i     # a view, no copy
    assert views["x1"][2] == 90 and views["y1"][2] == 190         # 100.5 -> 100, 200.5 -> 200
    frame = t(np.random.default_rng(1).integers(0, 256, (H, W, 3), dtype=np.uint8))
    crops, geo = sampler.crop_normalize(frame, t(boxes[:8]))
    assert torch.equal(geo, packed[:8]) and geo.dtype == torch.int32
    assert torch.equal(crops, sampler.sample_normalize_plain(
        frame, preprocess.crop_geometry(t(boxes[:8]), FRAME_HW)))


def test_pose_step_decodes_its_heatmaps_with_the_fused_decode(monkeypatch):
    """The pose step hands its own heatmaps, the crop's packed geometry and
    the mask to ``decode_keypoints`` (on the CPU its plain version) and
    returns what it gives."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_heatmaps, pose_step

    seen = {}

    def spy(heat, geo, mask, *a):
        seen.update(heat=heat, geo=geo, mask=mask, out=decode.decode_keypoints(heat, geo, mask))
        return seen["out"]

    monkeypatch.setattr(ps, "decode_keypoints", spy)

    cfg = ModelConfig("small", "coco", BackboneConfig(embed_dim=64, depth=1, num_heads=2),
                      HeadConfig(in_channels=64, num_keypoints=17, deconv_filters=(32, 32)))
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = np.array([[30, 20, 100, 110], [-10, 50, 60, 130], [80.5, 40.5, 81.5, 41.5]],
                     np.float32)
    mask = np.array([True, False, True])
    model = serving_copy(init_params(cfg, 0), "fp32")
    kp = pose_step(model, frame, boxes, mask, device="cpu")
    heat, geo = pose_heatmaps(model, t(frame), t(boxes))
    assert kp is seen["out"] and torch.equal(seen["mask"], t(mask))
    assert torch.equal(seen["geo"], preprocess.pack_geometry(geo))
    np.testing.assert_allclose(seen["heat"].numpy(), heat.detach().numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("u", [2.0, 3.0])
def test_a_singular_hessian_takes_no_newton_step(monkeypatch, u):
    """The modulated map flat around the peak (as where the blurred map is
    clipped at 0.001) but raised by the same u at its left and lower
    neighbours: dxx = dyy = u, dxy = -u, and at u >= 2 adding float32's eps
    rounds away, so the determinant is exactly 0 and the reference's step is
    infinite.  The decode keeps the argmax there (ROADMAP C20)."""
    c = -8.0                     # every sum below is exact in float32
    hm = torch.full((1, 1, 5, 5), c)
    hm[0, 0, 2, 1] = hm[0, 0, 3, 2] = c + u            # ix1_ and iy1
    monkeypatch.setattr(modulate, "udp_modulate_plain", lambda heat, kernel: hm.clone())
    heat = torch.zeros((1, 1, 5, 5))
    heat[0, 0, 2, 2] = 1.0
    coords, _ = decode.get_max_preds(heat)
    got = decode.post_dark_udp(coords, heat)
    assert got.tolist() == [[[2.0, 2.0]]]
