"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips on a host without a CUDA device.  The GPU
host has no JAX, so this file imports only torch, numpy and the port, and
runs there without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes are small and ragged (row counts that are not a multiple of the
GEMM tile, token counts that leave a partial query tile), where
chip_smoke.py holds the kernels at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from easy_vitpose_tpu_torch import kernels
from easy_vitpose_tpu_torch.models import fused_block as fb
from easy_vitpose_tpu_torch.models import quant, vit
from easy_vitpose_tpu_torch.ops import decode, modulate, preprocess, sampler

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(dev, *shape, scale=1.0, dtype=torch.float32, seed=0):
    g = np.random.default_rng(seed + sum(shape))
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("epi", [fb.EPI_NONE, fb.EPI_GELU, fb.EPI_RESIDUAL])
@pytest.mark.parametrize("M", [1, 100, 1000, 12288 + 77])
def test_gemm(dev, dtype, tol, epi, M):
    K, N = 256, 192
    a = randn(dev, M, K, dtype=dtype)
    w = randn(dev, N, K, scale=0.05, dtype=dtype)
    b = randn(dev, N, scale=0.1, dtype=dtype)
    res = randn(dev, M, N, dtype=dtype, seed=1)
    got = fb.gemm_cuda(a, w, b, epi, res if epi == fb.EPI_RESIDUAL else None)
    ref = vit.linear_f32(a, w, b)
    if epi == fb.EPI_GELU:
        ref = vit.gelu(ref)
    if epi == fb.EPI_RESIDUAL:
        ref = res.float() + ref.to(dtype).float()
    assert rel_err(got, ref.to(dtype)) <= tol


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", [fb.EPI_NONE, fb.EPI_GELU, fb.EPI_RESIDUAL])
@pytest.mark.parametrize("M", [300, 12288 + 77])
def test_gemm_q8(dev, out_dtype, epi, M):
    K, N = 384, 128
    h = randn(dev, M, K)
    wq, sw = quant.quantize_linear(randn(dev, N, K, scale=0.05))
    b = randn(dev, N, scale=0.1)
    res = randn(dev, M, N, dtype=out_dtype, seed=1)
    got = quant.gemm_q8_cuda(h, wq, sw, b, out_dtype, epi,
                             res if epi == fb.EPI_RESIDUAL else None)
    ref = quant.linear_q8(h, wq, sw, b)
    if epi == fb.EPI_GELU:
        ref = vit.gelu(ref)
    if epi == fb.EPI_RESIDUAL:
        ref = res.float() + ref.to(out_dtype).float()
    assert rel_err(got, ref.to(out_dtype)) <= (1e-5 if out_dtype == torch.float32 else 1e-2)


# a ViT block's four products at 64 crops of 192 tokens (M = 12288), in
# the tile widths the launch picks there (128 for qkv and fc1, 64 for proj
# and fc2), and at a ragged M
@pytest.mark.parametrize("N,K", [(2304, 768), (768, 768), (3072, 768), (768, 3072)])
@pytest.mark.parametrize("M", [12288, 12288 - 50])
def test_gemm_vit_shapes(dev, N, K, M):
    a = randn(dev, M, K, dtype=torch.bfloat16)
    w = randn(dev, N, K, scale=0.05, dtype=torch.bfloat16)
    b = randn(dev, N, scale=0.1, dtype=torch.bfloat16)
    got = fb.gemm_cuda(a, w, b, fb.EPI_GELU)
    assert rel_err(got, vit.gelu(vit.linear_f32(a, w, b)).bfloat16()) <= 1e-2
    h = randn(dev, M, K)
    wq, sw = quant.quantize_linear(randn(dev, N, K, scale=0.05))
    res = randn(dev, M, N, dtype=torch.bfloat16, seed=1)
    got = quant.gemm_q8_cuda(h, wq, sw, b.float(), torch.bfloat16, fb.EPI_RESIDUAL, res)
    ref = res.float() + quant.linear_q8(h, wq, sw, b.float()).bfloat16().float()
    assert rel_err(got, ref.bfloat16()) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowquant_bit_equal(dev, dtype):
    h = randn(dev, 77, 3072, scale=3.0, dtype=dtype)
    h[5] = 0
    q, s = quant.rowquant_cuda(h)
    rq, rs = quant.quant_rows(h)
    assert torch.equal(q, rq) and torch.equal(s, rs[:, 0])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("N", [50, 192, 200, 256])
@pytest.mark.parametrize("hd", [32, 40, 64, 80, 96, 128])
def test_attention(dev, dtype, tol, N, hd):
    """Head dims of ViT-S/B/L (32, 64), ViT-H (80), one padded to 48 (40)
    and the longer ones whose bf16 logits take key chunks (96, 128); token
    counts with a partial 16-key tile (50, 200) and the largest (256).
    float32 refuses the shapes whose FMA block exceeds shared memory."""
    B, heads = 3, 2
    qkv = randn(dev, B * N, 3 * heads * hd, dtype=dtype)
    if dtype == torch.float32 and fb.attention_smem_bytes(N, hd) > fb.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            fb.attention_cuda(qkv, B, N, heads)
        return
    got = fb.attention_cuda(qkv, B, N, heads)
    ref = vit.attention_core(qkv.reshape(B, N, -1), heads).reshape(B * N, -1)
    assert rel_err(got, ref) <= tol


@pytest.mark.parametrize("N,hd", [(257, 64), (192, 20), (192, 136)])
def test_attention_refuses_bf16_shapes(dev, N, hd):
    """No fallback: a bf16 shape the tensor-core kernels do not take raises."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    qkv = randn(dev, 2 * N, 3 * 2 * hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 attention"):
        fb.attention_cuda(qkv, 2, N, 2)
    with pytest.raises(ValueError, match="bf16 attention"):
        fbt.attention_backward_cuda(qkv, qkv[:, :2 * hd].contiguous(), 2, N, 2)


@pytest.mark.parametrize("x_dt,w_dt,o_dt", [(torch.float32,) * 3, (torch.bfloat16,) * 3,
                                            (torch.bfloat16, torch.float32, torch.float32)])
def test_layernorm(dev, x_dt, w_dt, o_dt):
    x = randn(dev, 333, 768, scale=2.0, dtype=x_dt) + 0.5
    w = randn(dev, 768, scale=0.2, dtype=w_dt) + 1
    b = randn(dev, 768, scale=0.2, dtype=w_dt)
    got = fb.layernorm_cuda(x, w, b, 1e-6, o_dt)
    ref = vit.layer_norm(x, w, b, 1e-6, o_dt)
    assert rel_err(got, ref) <= (1e-5 if o_dt == torch.float32 else 1e-2)


def test_sampler_edges(dev):
    H, W = 200, 300
    frame = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (H, W, 3),
                                                               dtype=np.uint8)).to(dev)
    boxes = torch.tensor([[10.5, 20.5, 60.5, 90.5], [-30, -40, 120, 150],
                          [W - 80, H - 60, W + 20, H + 5], [100.5, 80.5, 101.5, 81.5],
                          [W + 50, H + 50, W + 90, H + 80], [5, 100, W - 5, 130]],
                         dtype=torch.float32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        got, geo = sampler.crop_normalize(frame, boxes, dtype=dtype)
        ref, ref_geo = sampler.crop_normalize_plain(frame, boxes, dtype=dtype)
        assert torch.equal(got, ref) and torch.equal(geo, ref_geo)
    # a crop row of 17 * 3 values is no multiple of a 16-byte store
    got, geo = sampler.crop_normalize(frame, boxes, (17, 23), torch.bfloat16)
    ref, ref_geo = sampler.crop_normalize_plain(frame, boxes, (17, 23), torch.bfloat16)
    assert torch.equal(got, ref) and torch.equal(geo, ref_geo)


@pytest.mark.parametrize("shape,kernel", [((5, 17, 64, 48), 11), ((3, 4, 21, 15), 5),
                                          ((2, 5, 64, 48), 17),
                                          # the ViTPose+ tasks' keypoint counts
                                          ((64, 14, 64, 48), 11), ((64, 16, 64, 48), 11),
                                          ((64, 133, 64, 48), 11)])
def test_decode(dev, shape, kernel):
    """The fused decode against its plain version: scores and the argmax
    bit for bit, coordinates within 1e-3 heatmap px, the seven modulated
    points bit for bit those of the full-map kernel; bf16 heatmaps decode
    as their widening.  (21, 15) maps take the kernel's one-value loads."""
    from chip_smoke import decode_maps

    M, K, H, W = shape
    hm = torch.from_numpy(decode_maps(np.random.default_rng(0), *shape)).to(dev)
    boxes = torch.tensor(np.random.default_rng(1).uniform(0, 300, (M, 4)), dtype=torch.float32,
                         device=dev).sort(-1).values
    geo = sampler.crop_normalize(torch.zeros(240, 320, 3, dtype=torch.uint8, device=dev),
                                 boxes)[1]
    mask = torch.arange(M, device=dev) != 1
    got, pts = decode.decode_keypoints(hm, geo, mask, kernel, with_points=True)
    ref = decode.decode_keypoints_plain(hm, geo, mask, kernel)
    assert torch.equal(got[..., 2], ref[..., 2]) and (got[1] == 0).all()
    scale = torch.stack([geo[:, 5] / (H - 1), geo[:, 4] / (W - 1)], -1)[:, None, :]
    assert ((got[..., :2] - ref[..., :2]).abs() <= 1e-3 * scale + 1e-4).all()
    coords, _ = decode.get_max_preds(hm)
    full = modulate.udp_modulate(hm, kernel).reshape(-1)
    want = full[decode.newton_point_index(coords, H, W)]
    assert torch.equal(pts[mask], want[mask]) and (pts[~mask] == 0).all()
    hb = hm.bfloat16()
    assert torch.equal(decode.decode_keypoints(hb, geo, mask, kernel),
                       decode.decode_keypoints(hb.float(), geo, mask, kernel))


def test_pose_step_makes_the_host_wait_for_nothing(dev):
    """With its inputs on the card, a pose step runs under PyTorch's
    synchronisation check set to raise."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    cfg = ModelConfig("small", "coco", BackboneConfig(embed_dim=128, depth=1, num_heads=2),
                      HeadConfig(in_channels=128, num_keypoints=17, deconv_filters=(64, 64)))
    model = serving_copy(init_params(cfg, 0).to(dev), "int8")
    frame = torch.zeros(240, 320, 3, dtype=torch.uint8, device=dev)
    boxes = torch.tensor([[30, 20, 160, 200], [150, 100, 151, 101]], device=dev)
    mask = torch.ones(2, dtype=torch.bool, device=dev)
    pose_step(model, frame, boxes, mask)                     # first use: builds, caches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pose_step(model, frame, boxes, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("shape,kernel", [((3, 17, 64, 48), 11), ((2, 5, 96, 72), 17)])
def test_modulate(dev, shape, kernel):
    hm = randn(dev, *shape, scale=0.3) + 0.2
    got = modulate.udp_modulate(hm, kernel)
    assert float((got - modulate.udp_modulate_plain(hm, kernel)).abs().max()) <= 1e-5


def test_counters_and_refusals(dev):
    kernels.reset_launch_counts()
    hm = randn(dev, 1, 2, 64, 48)
    modulate.udp_modulate(hm)
    modulate.udp_modulate(hm)
    assert kernels.launch_counts() == {"modulate": 2}
    with pytest.raises(ValueError, match="multiple of 64"):
        fb.gemm_cuda(randn(dev, 8, 64), randn(dev, 96, 64), randn(dev, 96))
    with pytest.raises(ValueError, match="float32"):
        modulate.udp_modulate(hm.double())
    geo = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    mask = torch.ones(1, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        decode.decode_keypoints(hm.double(), geo, mask)
    with pytest.raises(ValueError, match="int32"):
        decode.decode_keypoints(hm, geo.long(), mask)
    with pytest.raises(ValueError, match="kernel 12"):
        decode.decode_keypoints(hm, geo, mask, 12)
    frame = torch.zeros(8, 8, 3, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        sampler.crop_normalize(frame, torch.zeros(1, 4, dtype=torch.float64, device=dev))
    assert kernels.launch_counts() == {"modulate": 2}


def test_pose_step_from_numpy(dev, monkeypatch):
    """The user's entry point with numpy inputs runs on the card, through
    every kernel once per layer, and agrees with the plain path; its
    keypoints are the plain decode of its own heatmaps."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_heatmaps, pose_step

    seen = {}

    def spy(heat, geo, mask, *a, **k):
        seen.update(heat=heat, geo=geo, mask=mask)
        return decode.decode_keypoints(heat, geo, mask, *a, **k)

    monkeypatch.setattr(ps, "decode_keypoints", spy)

    cfg = ModelConfig("small", "coco", BackboneConfig(embed_dim=128, depth=2, num_heads=2),
                      HeadConfig(in_channels=128, num_keypoints=17, deconv_filters=(64, 64)))
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    boxes = np.array([[30, 20, 160, 200], [-10, 150, 60, 260], [150, 100, 151, 101]],
                     np.float32)
    mask = np.array([True, False, True])
    model = init_params(cfg, 0).to(dev)
    for dtype, block in (("int8", "block_q8"), ("bf16", "block"), ("fp32", "block")):
        sm = serving_copy(model, dtype)
        kernels.reset_launch_counts()
        kp = pose_step(sm, frame, boxes, mask)
        assert kernels.launch_counts() == {block: 2, "sampler": 1, "decode": 1}
        assert kp.is_cuda and torch.isfinite(kp).all() and (kp[1] == 0).all()
        with torch.no_grad():
            t = [torch.from_numpy(a).to(dev) for a in (frame, boxes)]
            hk, _ = pose_heatmaps(sm, *t)
            hp, _ = pose_heatmaps(sm, *t, plain=True)
        span = float(hp.max() - hp.min())
        assert float((hk - hp).abs().max()) <= (1e-4 if dtype == "fp32" else 0.05) * span
        ref = decode.decode_keypoints_plain(seen["heat"], seen["geo"], seen["mask"])
        assert torch.equal(kp[..., 2], ref[..., 2])
        assert float((kp - ref).abs().max()) <= 1e-2


@pytest.mark.parametrize("K", [14, 16, 133])
def test_pose_step_at_task_keypoints(dev, K, monkeypatch):
    """The ViTPose+ tasks' heads (aic 14, mpii 16, wholebody 133 keypoints):
    K3's crops and geometry equal the plain version's bits, the int8 pose
    step launches K3 and the decode once, its heatmaps are within the
    bound of test_pose_step_from_numpy of the plain path's, and its
    keypoints are the plain decode of its own heatmaps."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_heatmaps, pose_step

    seen = {}

    def spy(heat, geo, mask, *a, **k):
        seen.update(heat=heat, geo=geo, mask=mask)
        return decode.decode_keypoints(heat, geo, mask, *a, **k)

    monkeypatch.setattr(ps, "decode_keypoints", spy)
    cfg = ModelConfig("small", "aic", BackboneConfig(embed_dim=128, depth=2, num_heads=2),
                      HeadConfig(in_channels=128, num_keypoints=K, deconv_filters=(64, 64)))
    rng = np.random.default_rng(K)
    frame = torch.from_numpy(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)).to(dev)
    boxes = torch.tensor([[30, 20, 160, 200], [-10, 150, 60, 260], [150, 100, 151, 101],
                          [200.5, 10.5, 330.5, 250.5]], dtype=torch.float32, device=dev)
    mask = torch.tensor([True, False, True, True], device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        got, geo = sampler.crop_normalize(frame, boxes, dtype=dtype)
        ref, ref_geo = sampler.crop_normalize_plain(frame, boxes, dtype=dtype)
        assert torch.equal(got, ref) and torch.equal(geo, ref_geo)
    model = serving_copy(init_params(cfg, 0).to(dev), "int8")
    kernels.reset_launch_counts()
    kp = pose_step(model, frame, boxes, mask)
    assert kernels.launch_counts() == {"block_q8": 2, "sampler": 1, "decode": 1}
    assert kp.shape == (4, K, 3) and torch.isfinite(kp).all() and (kp[1] == 0).all()
    with torch.no_grad():
        hk, _ = pose_heatmaps(model, frame, boxes)
        hp, _ = pose_heatmaps(model, frame, boxes, plain=True)
    assert hk.shape == (4, K, 64, 48)
    assert float((hk - hp).abs().max()) <= 0.05 * float(hp.max() - hp.min())
    ref = decode.decode_keypoints_plain(seen["heat"], seen["geo"], seen["mask"])
    assert torch.equal(kp[..., 2], ref[..., 2])
    assert float((kp - ref).abs().max()) <= 1e-2


@pytest.mark.parametrize("size", ["s", "b", "l", "h"])
def test_block_at_each_vit_width(dev, size):
    """K1 and K2 on one block of each ViT size (head dim 32, 64, 64, 80)."""
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vit import Block

    cfg = get_model_config("coco", size).backbone
    blk = Block(cfg).to(dev)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            ln_scale = name.startswith("norm") and name.endswith("weight")
            p.copy_(randn(dev, *p.shape, scale=0.02) + (1.0 if ln_scale else 0.0))
    x = randn(dev, 2, cfg.num_tokens, cfg.embed_dim)
    for dtype in (torch.float32, torch.bfloat16):
        b = blk.to(dtype)
        got = fb.fused_block(x.to(dtype), b)
        assert rel_err(got, vit.block(x.to(dtype), b)) <= (1e-4 if dtype == torch.float32 else 2e-2)
    qb = quant.QBlock(blk.float())
    got = quant.fused_block_q8(x.bfloat16(), qb)
    assert rel_err(got, quant.block_q8(x.bfloat16(), qb)) <= 2e-2


# ------------------------------------------------------------ training (K5-K8)
def block_weights(dev, D, hidden, dtype, seed=0):
    from easy_vitpose_tpu_torch.models.vit import BlockWeights
    shapes = [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
              (hidden, D), (hidden,), (D, hidden), (D,)]
    scales = [0.1, 0.05, 0.15, 0.05, 0.1, 0.05, 0.1, 0.05, 0.1, 0.05, 0.06, 0.05]
    ws = [randn(dev, *s, scale=sc, seed=seed + i) for i, (s, sc) in enumerate(zip(shapes, scales))]
    ws[0], ws[6] = ws[0] + 1, ws[6] + 1                 # LN scales around 1
    return BlockWeights(*(w.to(dtype) for w in ws))


@pytest.mark.parametrize("R,K,N", [(200, 136, 72), (8, 8, 8), (1000, 392, 264),
                                   (2048, 1024, 640)])
@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_train_gemm_layouts(dev, layout, dtype, tol, R, K, N):
    """The training GEMM in its three layouts against float32 matmul of the
    same operands, at sizes that are multiples of 8 but not of a tile: one
    partial tile of every dim (8 x 8 x 8; K 136, N 72: a k-tile and a
    column tile cut short), several row and column tiles with ragged edges,
    and 16 k-tiles; TN as the pair launch of two products of different
    shapes (the second 24 wide), contracted over R rows.  A second call
    gives the same bits (one fixed-order sum per output, no atomics)."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    if layout == "nt":
        a, w = randn(dev, R, K, dtype=dtype), randn(dev, N, K, scale=0.1, dtype=dtype)
        b = randn(dev, N, scale=0.1, dtype=dtype)
        run = lambda: fbt.gemm_nt(a, w, fbt.TE_NONE, bias=b)[:1]  # noqa: E731
        refs = [a.float() @ w.float().t() + b.float()]
    elif layout == "nn":
        a, w = randn(dev, R, K, dtype=dtype), randn(dev, K, N, scale=0.1, dtype=dtype)
        run = lambda: fbt.gemm_nn(a, w, fbt.TE_F32)[1:]  # noqa: E731
        refs = [a.float() @ w.float()]
    else:
        a, b = randn(dev, R, K, dtype=dtype), randn(dev, R, N, dtype=dtype, seed=1)
        a1, b1 = randn(dev, R, 24, dtype=dtype, seed=2), randn(dev, R, K, dtype=dtype, seed=3)
        run = lambda: fbt.gemm_tn2(a, b, a1, b1)  # noqa: E731
        refs = [a.float().t() @ b.float(), a1.float().t() @ b1.float()]
    got = run()
    for g, ref in zip(got, refs):
        assert rel_err(g, ref.to(g.dtype)) <= tol
    assert all(torch.equal(g, g2) for g, g2 in zip(got, run()))


@pytest.mark.parametrize("mode", range(9))
@pytest.mark.parametrize("layout", ["nt", "nn"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_train_gemm_epilogues(dev, mode, layout, dtype, tol):
    """Each of the nine epilogues (both families) after an NT and an NN
    product with three row tiles and a partial column tile, against its
    formula on float32 matmul of the same operands: the bias, GELU, the
    drop-path residual over three crops of 100 rows, GELU saving the
    pre-activation in float32 or rounded, and the GELU derivative of a
    float32 or a saved pre-activation (each output within 1e-5 at float32,
    1e-2 at bf16 of its largest value: the sums run in another order)."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    R, K, N, tokens = 300, 136, 200, 100
    a = randn(dev, R, K, dtype=dtype)
    if layout == "nt":
        w = randn(dev, N, K, scale=0.1, dtype=dtype, seed=1)
        acc, gemm = a.float() @ w.float().t(), fbt.gemm_nt
    else:
        w = randn(dev, K, N, scale=0.1, dtype=dtype, seed=1)
        acc, gemm = a.float() @ w.float(), fbt.gemm_nn
    bias = randn(dev, N, scale=0.1, dtype=dtype, seed=2)
    res = randn(dev, R, N, dtype=dtype, seed=3)
    dp = torch.tensor([1.25, 0.0, 2.0], device=dev)
    aux = randn(dev, R, N, seed=4)
    v = acc + bias.float()
    rnd = lambda t: t.to(dtype)  # noqa: E731
    kw, want = {"bias": bias}, {
        fbt.TE_NONE: (rnd(v), None),
        fbt.TE_GELU: (rnd(vit.gelu(v)), None),
        fbt.TE_DP_RES: (rnd(res.float() + v * dp.repeat_interleave(tokens)[:, None]), None),
        fbt.TE_GELU_SAVE: (rnd(vit.gelu(v)), v),
        fbt.TE_GELU_GRAD: (None, acc * fbt.gelu_grad(aux)),
        fbt.TE_F32: (None, v),
        fbt.TE_GELU_SAVE_T: (rnd(vit.gelu(v)), rnd(v)),
        fbt.TE_GELU_GRAD_T: (rnd(acc * fbt.gelu_grad(aux)), None),
        fbt.TE_GELU_GRAD_MS: (rnd(vit.gelu(rnd(aux).float())), acc * fbt.gelu_grad(rnd(aux).float())),
    }[mode]
    if mode == fbt.TE_DP_RES:
        kw.update(res=res, dp=dp, tokens=tokens)
    elif mode in (fbt.TE_GELU_GRAD, fbt.TE_GELU_GRAD_T):
        kw = {"aux": aux}
    elif mode == fbt.TE_GELU_GRAD_MS:
        kw = {"aux": rnd(aux)}
    for g, ref in zip(gemm(a, w, mode, **kw), want):
        assert (g is None) == (ref is None)
        if ref is not None:
            assert g.dtype == ref.dtype and g.shape == ref.shape
            assert rel_err(g, ref) <= tol


def test_train_gemm_tn2_refuses_misaligned_operands(dev):
    """The TN pair reads its operands by TMA: one that starts 8 bytes into
    its storage is refused before the launch."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    ok = torch.zeros(16, 8, dtype=torch.bfloat16, device=dev)
    bad = torch.zeros(16 * 8 + 4, dtype=torch.bfloat16, device=dev)[4:].view(16, 8)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fbt.gemm_tn2(ok, ok, bad, ok)


def test_mma_probe(dev):
    """The mma.sync probe against float32 matmul of the same bf16 operands,
    at K7's ViT-B head shape (192 tokens, head dim 64)."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    x, y = randn(dev, 192, 64, dtype=torch.bfloat16), randn(dev, 192, 64, dtype=torch.bfloat16, seed=1)
    assert rel_err(fbt.mma_probe(x, y), x.float() @ y.float().t()) <= 1e-5


@pytest.mark.parametrize("D,heads,N", [(128, 2, 192), (64, 2, 50), (1280, 16, 50),
                                       (1280, 16, 192), (320, 8, 256), (256, 2, 77)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_train_block_kernels(dev, D, heads, N, dtype, tol):
    """K5, K6a and K7 against their plain versions at three crops, one of
    them dropped, head dims 64, 32 and 80 (ViT-H's 1280 / 16, also at its
    serving 192 tokens), 40 at 256 tokens (padded to 48; the logits of a
    row in two key chunks) and 128 (key chunks in both kernels), a partial
    attention tile at N=50 and 77: each output and gradient relative to its
    largest plain value (float32 sums in another order; at bf16 a rounding
    may flip)."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    B, eps = 3, 1e-6
    w = block_weights(dev, D, 4 * D, dtype)
    x = randn(dev, B, N, D, dtype=dtype)
    keep = torch.tensor([1.25, 0.0, 1.25], device=dev)
    dout = randn(dev, B, N, D, dtype=dtype, seed=2)
    kernels.reset_launch_counts()
    out, x1, _, _ = fbt.train_forward(x, keep, w, heads, eps)
    ref_out, ref_x1, _, _ = fbt.train_forward_plain(x, keep, w, heads, eps)
    assert rel_err(out, ref_out) <= tol and rel_err(x1, ref_x1) <= tol
    dx1, gm = fbt.mlp_backward(ref_x1, dout, keep, w, eps)
    rdx1, rgm = fbt.mlp_backward_plain(ref_x1, dout, keep, w, eps)
    dx, ga = fbt.attn_backward(x, rdx1, keep, w, heads, eps)
    rdx, rga = fbt.attn_backward_plain(x, rdx1, keep, w, heads, eps)
    for got, ref in zip((dx1, dx, *gm, *ga), (rdx1, rdx, *rgm, *rga)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert rel_err(got, ref) <= tol
    assert kernels.launch_counts() == {fbt.FWD: 1, fbt.BWD_MLP: 1, fbt.BWD_ATTN: 1}


@pytest.mark.parametrize("D,N", [(1024, 50), (1280, 77)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_wide_mlp_backward_kernels(dev, D, N, dtype, tol):
    """K6b and K6c against their plain versions at ViT-L's and ViT-H's
    widths with ragged row counts (3 * 50, 3 * 77), one crop dropped; K6c
    fed the plain K6b's operands.  K6b then K6c gives K6a's result bit for
    bit (the same launches, and the same tile loop in K6c)."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    B, eps = 3, 1e-6
    w = block_weights(dev, D, 4 * D, dtype)
    x1 = randn(dev, B, N, D, dtype=dtype)
    keep = torch.tensor([2.0, 0.0, 2.0], device=dev)
    dout = randn(dev, B, N, D, scale=0.1, dtype=dtype, seed=2)
    kernels.reset_launch_counts()
    got = fbt.mlp_backward_dx_save(x1, dout, keep, w, eps)
    ref = fbt.mlp_backward_dx_save_plain(x1, dout, keep, w, eps)
    dW = fbt.mlp_backward_dw_saved(*ref[1:5])
    rdW = fbt.mlp_backward_dw_saved_plain(*ref[1:5])
    for g, r in zip((*got, *dW), (*ref, *rdW)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert rel_err(g, r) <= tol
    assert kernels.launch_counts() == {fbt.BWD_MLP_DX_SAVE: 1, fbt.BWD_MLP_DW_SAVED: 1}
    k6a = fbt.mlp_backward(x1, dout, keep, w, eps)
    wide = fbt.wide_mlp_backward(x1, dout, keep, w, eps)
    for a, b in zip((k6a[0], *k6a[1]), (wide[0], *wide[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D,heads,N", [(128, 2, 192), (64, 2, 50), (1280, 16, 50),
                                       (1280, 16, 192)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_saved_flavor_kernels(dev, D, heads, N, dtype, tol):
    """K5's saved qkv and m, K7 ``_saved`` and K6a ``_ms`` against their
    plain versions (fed the plain forward's qkv, x1 and m); K7 ``_saved`` on
    K5's own qkv is K7 bit for bit (the same GEMM on the same LN output); at
    float32 K6a ``_ms`` is K6a's function within 1e-6."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    B, eps = 3, 1e-6
    w = block_weights(dev, D, 4 * D, dtype)
    x = randn(dev, B, N, D, dtype=dtype)
    keep = torch.tensor([1.25, 0.0, 1.25], device=dev)
    dout = randn(dev, B, N, D, dtype=dtype, seed=2)
    kernels.reset_launch_counts()
    got = fbt.train_forward(x, keep, w, heads, eps, save_qkv=True, save_m=True)
    ref = fbt.train_forward_plain(x, keep, w, heads, eps, save_qkv=True, save_m=True)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert rel_err(g, r) <= tol
    _, rx1, rqkv, rm = ref
    flat = lambda res: (res[0], *res[1])  # noqa: E731
    saved = flat(fbt.attn_backward(x, dout, keep, w, heads, eps, qkv=got[2]))
    for a, b in zip(saved, flat(fbt.attn_backward(x, dout, keep, w, heads, eps))):
        assert torch.equal(a, b)
    for g, r in zip(flat(fbt.attn_backward(x, dout, keep, w, heads, eps, qkv=rqkv)),
                    flat(fbt.attn_backward_plain(x, dout, keep, w, heads, eps, rqkv))):
        assert g.dtype == r.dtype and rel_err(g, r) <= tol
    ms = flat(fbt.mlp_backward(rx1, dout, keep, w, eps, m=rm))
    for g, r in zip(ms, flat(fbt.mlp_backward_plain(rx1, dout, keep, w, eps, rm))):
        assert g.dtype == r.dtype and rel_err(g, r) <= tol
    assert kernels.launch_counts() == {fbt.FWD: 1, fbt.BWD_ATTN_SAVED: 2, fbt.BWD_ATTN: 1,
                                       fbt.BWD_MLP_MS: 1}
    if dtype == torch.float32:          # on K5's own x1 and m: the m K6a recomputes
        for g, r in zip(flat(fbt.mlp_backward(got[1], dout, keep, w, eps, m=got[3])),
                        flat(fbt.mlp_backward(got[1], dout, keep, w, eps))):
            assert rel_err(g, r) <= 1e-6


@pytest.mark.parametrize("D,N", [(1024, 50), (1280, 77)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_wide_flavor_kernels(dev, D, N, dtype, tol):
    """K6b ``_ms``, K6d and K6e against their plain versions at ViT-L's and
    ViT-H's widths with ragged row counts; K6d then K6e is K6b then K6c bit
    for bit; at float32 K6b ``_ms`` on the m K5 saves is K6b within 1e-6."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vit import layer_norm, linear_f32
    B, eps = 3, 1e-6
    w = block_weights(dev, D, 4 * D, dtype)
    x1 = randn(dev, B, N, D, dtype=dtype)
    keep = torch.tensor([2.0, 0.0, 2.0], device=dev)
    dout = randn(dev, B, N, D, scale=0.1, dtype=dtype, seed=2)
    m = linear_f32(layer_norm(x1, w.ln2_w, w.ln2_b, eps), w.fc1_w, w.fc1_b).to(dtype)
    kernels.reset_launch_counts()
    got = fbt.mlp_backward_dx_save(x1, dout, keep, w, eps, m=m)
    pairs = [(got, fbt.mlp_backward_dx_save_plain(x1, dout, keep, w, eps, m)),
             (fbt.mlp_backward_dx(x1, dout, keep, w, eps),
              fbt.mlp_backward_dx_plain(x1, dout, keep, w, eps)),
             (fbt.mlp_backward_dw(x1, dout, keep, w, eps),
              fbt.mlp_backward_dw_plain(x1, dout, keep, w, eps))]
    for gs, rs in pairs:
        for g, r in zip(gs, rs):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert rel_err(g, r) <= tol
    assert kernels.launch_counts() == {fbt.BWD_MLP_DX_SAVE_MS: 1, fbt.BWD_MLP_DX: 1,
                                       fbt.BWD_MLP_DW: 1}
    rec = fbt.wide_mlp_backward_recompute(x1, dout, keep, w, eps)
    sav = fbt.wide_mlp_backward(x1, dout, keep, w, eps)
    for a, b in zip((rec[0], *rec[1]), (sav[0], *sav[1])):
        assert torch.equal(a, b)
    if dtype == torch.float32:          # on the m that K5's launches save for this x1
        h2 = fb.layernorm_cuda(x1.reshape(B * N, D), w.ln2_w, w.ln2_b, eps, dtype)
        m5 = fbt.gemm_nt(h2, w.fc1_w, fbt.TE_GELU_SAVE_T, bias=w.fc1_b)[1].reshape(B, N, -1)
        for g, r in zip(fbt.mlp_backward_dx_save(x1, dout, keep, w, eps, m=m5),
                        fbt.mlp_backward_dx_save(x1, dout, keep, w, eps)):
            assert rel_err(g, r) <= 1e-6


@pytest.mark.parametrize("n", [1, 2048, 2048 * 3 + 5, (1 << 20) + 7])
def test_adam_q8_kernel_bit_equal(dev, n):
    """K9 on leaves of any length, from moments the codec wrote, is bit-equal
    to its plain version on the card: codes, scales and params."""
    from easy_vitpose_tpu_torch.train.fused_opt import adam_leaf_q8, adam_leaf_q8_plain, q8_encode
    g, p = randn(dev, n, scale=1e-3), randn(dev, n, seed=3)
    mq, ms = q8_encode(randn(dev, n, scale=1e-3, seed=1), 127)
    nq, ns = q8_encode(randn(dev, n, scale=1e-3, seed=2).abs(), 255)
    scal = torch.tensor([0.7, 3.75e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    for a, b in zip(adam_leaf_q8(g, mq, ms, nq, ns, p, scal),
                    adam_leaf_q8_plain(g, mq, ms, nq, ns, p, scal)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 1000, 768 * 3072 + 5])
def test_adam_kernel_bit_equal(dev, n):
    """K8 on leaves of any length is bit-equal to its plain version."""
    from easy_vitpose_tpu_torch.train.fused_opt import adam_leaf, adam_leaf_plain
    g, mu = randn(dev, n, scale=1e-3), randn(dev, n, scale=1e-3, seed=1)
    nu, p = randn(dev, n, scale=1e-3, seed=2).square(), randn(dev, n, seed=3)
    scal = torch.tensor([0.7, 3.75e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    for got, ref in zip(adam_leaf(g, mu, nu, p, scal), adam_leaf_plain(g, mu, nu, p, scal)):
        assert torch.equal(got, ref)


# ragged leaf sets for the optimizer's table launches: lengths around the
# 2048-element unit, empty and 0-d leaves, and 300 leaves of 0-2100
TABLE_SETS = {
    "ragged": [(1,), (3,), (1001,), (2047,), (2048,), (2049,)],
    "shapes": [(), (0,), (7, 300), (5000,), (3, 5), (64, 33)],
    "many": [(int(n),) for n in np.random.default_rng(5).integers(0, 2100, 300)],
}


def table_leaves(dev, shapes, scale, seed, misalign=False):
    """float32 leaves from a numpy seed; with ``misalign`` every other leaf
    is a view one element into its buffer (the kernels' scalar path)."""
    g = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        v = torch.from_numpy(np.asarray(g.standard_normal(s) * scale, np.float32)).to(dev)
        if misalign and i % 2:
            buf = torch.empty(v.numel() + 1, device=dev)
            buf[1:] = v.reshape(-1)
            v = buf[1:].view(v.shape)
        out.append(v)
    return out


@pytest.mark.parametrize("misalign", [False, True])
@pytest.mark.parametrize("name", list(TABLE_SETS))
def test_adam_table_launches_bit_equal(dev, name, misalign):
    """K8 and K9 over a whole leaf set in one launch each, bit-equal to
    their per-leaf plain versions with the same scalar buffer."""
    from easy_vitpose_tpu_torch.train import fused_opt as fo
    shapes = TABLE_SETS[name]
    g, p = table_leaves(dev, shapes, 1e-3, 1, misalign), table_leaves(dev, shapes, 1.0, 2, misalign)
    mu = table_leaves(dev, shapes, 1e-3, 3, misalign)
    nu = [t.square() for t in table_leaves(dev, shapes, 1e-3, 4)]
    scal = torch.tensor([0.37, 3.75e-4, 1 - 0.9 ** 7, 1 - 0.999 ** 7], device=dev)
    kernels.reset_launch_counts()
    out = fo.adam_table(g, mu, nu, p, scal)
    st = [(*fo.q8_encode(m, 127), *fo.q8_encode(v.sqrt(), 255)) for m, v in zip(mu, nu)]
    mq, ms, nq, ns = (list(x) for x in zip(*st))
    out8 = fo.adam_table_q8(g, mq, ms, nq, ns, p, scal)
    assert kernels.launch_counts() == {fo.KERNEL: 1, fo.KERNEL_Q8: 1}
    for i in range(len(shapes)):
        ref = fo.adam_leaf_plain(g[i], mu[i], nu[i], p[i], scal)
        assert all(torch.equal(o[i], r) for o, r in zip(out, ref)), (name, i)
        if g[i].numel():
            ref = fo.adam_leaf_q8_plain(g[i], mq[i], ms[i], nq[i], ns[i], p[i], scal)
            assert all(o[i].dtype == r.dtype and torch.equal(o[i], r)
                       for o, r in zip(out8, ref)), (name, i)


@pytest.mark.parametrize("name", list(TABLE_SETS))
def test_grad_norm_kernel(dev, name):
    """The norm kernel against ``global_norm``: bit for bit on leaves whose
    sum of squares is exact (+-c, +-2c, c a power of two), within rel 1e-5
    on random ones; the clip scale from its norm, as the plain version."""
    from easy_vitpose_tpu_torch.train import fused_opt as fo
    shapes = TABLE_SETS[name]
    rng = np.random.default_rng(7)
    exact = [torch.from_numpy(rng.choice(np.float32([-2, -1, 1, 2]) * 2.0 ** -6, s)
                              .astype(np.float32)).to(dev) for s in shapes]
    for gs, tol in ((exact, 0.0), (table_leaves(dev, shapes, 1e-2, 8, True), 1e-5)):
        kernels.reset_launch_counts()
        sg = fo.clip_scale(gs, 1.0)
        assert kernels.launch_counts() == {fo.KERNEL_NORM: 1}
        ref = fo.clip_scale_plain(gs, 1.0)
        assert abs(float(sg[1]) - float(ref[1])) <= tol * float(ref[1]), (float(sg[1]), float(ref[1]))
        s = torch.minimum(torch.ones_like(sg[1]), torch.full_like(sg[1], 1.0) / (sg[1] + 1e-16))
        assert torch.equal(sg[0], s)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_fused_apply_on_the_card(dev, moments):
    """One step over ragged leaves: the norm kernel and K8 (K9) once each,
    none of the inputs written, and the outputs bit-equal to the per-leaf
    plain versions with the kernel's clip scale."""
    from easy_vitpose_tpu_torch.train import fused_opt as fo
    shapes = TABLE_SETS["ragged"] + TABLE_SETS["shapes"][2:]
    names = [f"l{i}" for i in range(len(shapes))]
    params = dict(zip(names, table_leaves(dev, shapes, 0.5, 9)))
    grads = dict(zip(names, table_leaves(dev, shapes, 1e-2, 10, True)))
    tx = fo.make_fused_adam(3.75e-4, moment_dtype=moments)
    params, state, _ = tx.fused_apply(grads, tx.init(params), params)    # non-zero moments
    leaves = lambda: [t.clone() for t in (*grads.values(), *params.values(),    # noqa: E731
                                          *(v for m in (state.mu, state.nu) for v in
                                            (m["q_tree"].values() if moments == "int8" else
                                             m.values())))]
    before = leaves()
    kernels.reset_launch_counts()
    new, new_state, gnorm = tx.fused_apply(grads, state, params)
    assert kernels.launch_counts() == {fo.KERNEL_NORM: 1,
                                       fo.KERNEL_Q8 if moments == "int8" else fo.KERNEL: 1}
    assert all(torch.equal(a, b) for a, b in zip(before, leaves()))
    sg = fo.clip_scale(list(grads.values()), 1.0)
    assert float(sg[1]) == float(gnorm)
    cf = new_state.count.float()
    scal = torch.stack([sg[0], state.hyperparams["learning_rate"],
                        1.0 - torch.pow(torch.full_like(cf, fo.B1), cf),
                        1.0 - torch.pow(torch.full_like(cf, fo.B2), cf)])
    for k in names:
        if moments == "int8":
            ref = fo.adam_leaf_q8_plain(grads[k], state.mu["q_tree"][k], state.mu["s_tree"][k],
                                        state.nu["q_tree"][k], state.nu["s_tree"][k], params[k],
                                        scal)
            got = (new_state.mu["q_tree"][k], new_state.mu["s_tree"][k],
                   new_state.nu["q_tree"][k], new_state.nu["s_tree"][k], new[k])
        else:
            ref = fo.adam_leaf_plain(grads[k], state.mu[k], state.nu[k], params[k], scal)
            got = (new_state.mu[k], new_state.nu[k], new[k])
        assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, ref)), k


def test_train_step_through_the_kernels(dev):
    """Two AMP steps of a small model through the kernels: each block's K5,
    K6a and K7 once per step, the norm kernel and K8 once per step, and the
    loss and every gradient against the plain step on the card."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import step as tstep
    from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam

    cfg = ModelConfig("small", "coco", BackboneConfig(embed_dim=128, depth=2, num_heads=2,
                                                      drop_path_rate=0.3),
                      HeadConfig(in_channels=128, num_keypoints=17, deconv_filters=(64, 64)))
    rng = np.random.default_rng(0)
    batch = {"images_u8": rng.integers(0, 256, (3, 256, 192, 3), dtype=np.uint8),
             "joints": rng.uniform(0, 190, (3, 17, 2)).astype(np.float32),
             "joints_vis": np.ones((3, 17, 2), np.float32)}
    tx = make_fused_adam(3.75e-4)
    state = tstep.init_train_state(init_params(cfg, 0).to(dev), tx)
    step = tstep.make_train_step(cfg, tx)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        kernels.reset_launch_counts()
        state, metrics = step(state, batch, gen)
        assert kernels.launch_counts() == {"train_fwd": 2, "train_bwd_mlp": 2,
                                           "train_bwd_attn": 2, "adam": 1, "grad_norm": 1}
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    rendered = tstep.render_batch_on_device(batch, dev)
    masks = torch.tensor([[1.0, 0.0, 1.0], [1.43, 1.43, 0.0]], device=dev).reshape(2, 3, 1, 1)
    lk, _, gk = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks)
    lp, _, gp = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks, plain=True)
    assert abs(float(lk) - float(lp)) <= 1e-2 * float(lp)
    for k in gp:
        assert rel_err(gk[k], gp[k]) <= 0.1, k


def test_wide_train_step_with_int8_moments(dev):
    """Two AMP steps of a small wide model (D=1024, the ViT-L width) with
    int8 moments through the kernels: K5, K6b, K6c and K7 once per block,
    the norm kernel and K9 once per step and no K6a or K8; the loss and
    every gradient against the plain step on the card."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import step as tstep
    from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam

    cfg = ModelConfig("wide", "coco", BackboneConfig(embed_dim=1024, depth=2, num_heads=16,
                                                     drop_path_rate=0.5),
                      HeadConfig(in_channels=1024, num_keypoints=17, deconv_filters=(64, 64)))
    rng = np.random.default_rng(1)
    batch = {"images_u8": rng.integers(0, 256, (3, 256, 192, 3), dtype=np.uint8),
             "joints": rng.uniform(0, 190, (3, 17, 2)).astype(np.float32),
             "joints_vis": np.ones((3, 17, 2), np.float32)}
    tx = make_fused_adam(3.75e-4, moment_dtype="int8")
    state = tstep.init_train_state(init_params(cfg, 0), tx)
    assert state["step"].is_cuda and state["opt_state"].mu["q_tree"]["backbone.pos_embed"].is_cuda
    step = tstep.make_train_step(cfg, tx)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        kernels.reset_launch_counts()
        state, metrics = step(state, batch, gen)
        assert kernels.launch_counts() == {"train_fwd": 2, "train_bwd_mlp_dx_save": 2,
                                           "train_bwd_mlp_dw_saved": 2, "train_bwd_attn": 2,
                                           "adam_q8": 1, "grad_norm": 1}
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    rendered = tstep.render_batch_on_device(batch, dev)
    masks = torch.tensor([[2.0, 0.0, 2.0], [2.0, 2.0, 0.0]], device=dev).reshape(2, 3, 1, 1)
    lk, _, gk = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks)
    lp, _, gp = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks, plain=True)
    assert abs(float(lk) - float(lp)) <= 1e-2 * float(lp)
    for k in gp:
        assert rel_err(gk[k], gp[k]) <= 0.1, k


def small_model(D, heads, drop_path):
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    return ModelConfig("small", "coco", BackboneConfig(embed_dim=D, depth=2, num_heads=heads,
                                                       drop_path_rate=drop_path),
                       HeadConfig(in_channels=D, num_keypoints=17, deconv_filters=(64, 64)))


def small_batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return {"images_u8": rng.integers(0, 256, (n, 256, 192, 3), dtype=np.uint8),
            "joints": rng.uniform(0, 190, (n, 17, 2)).astype(np.float32),
            "joints_vis": np.ones((n, 17, 2), np.float32)}


@pytest.mark.parametrize("D,heads,moments,env,want", [
    (128, 2, "f32", {"EVT_TRAIN_ATTN": "saved", "EVT_TRAIN_MLP": "saved"},
     ("train_fwd", "train_bwd_mlp_ms", "train_bwd_attn_saved")),
    (1024, 16, "int8", {"EVT_TRAIN_WIDE": "recompute"},
     ("train_fwd", "train_bwd_mlp_dx", "train_bwd_mlp_dw", "train_bwd_attn")),
    (1024, 16, "int8", {"EVT_TRAIN_MLP": "saved"},
     ("train_fwd", "train_bwd_mlp_dx_save_ms", "train_bwd_mlp_dw_saved", "train_bwd_attn"))])
def test_flavored_train_steps_through_the_kernels(dev, D, heads, moments, env, want, monkeypatch):
    """Two AMP steps of a small model under each flavor's switches: each
    block kernel of the flavor once per block and step, and no other; the
    loss and every gradient against the plain step under the same switches."""
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import step as tstep
    from easy_vitpose_tpu_torch.train.fused_opt import (KERNEL, KERNEL_NORM, KERNEL_Q8,
                                                        make_fused_adam)

    for k in ("EVT_TRAIN_ATTN", "EVT_TRAIN_MLP", "EVT_TRAIN_WIDE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = small_model(D, heads, 0.5)
    batch = small_batch(2, 3)
    tx = make_fused_adam(3.75e-4, moment_dtype=moments)
    state = tstep.init_train_state(init_params(cfg, 0), tx)
    step = tstep.make_train_step(cfg, tx)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        kernels.reset_launch_counts()
        state, metrics = step(state, batch, gen)
        assert kernels.launch_counts() == {**dict.fromkeys(want, 2), KERNEL_NORM: 1,
                                           (KERNEL_Q8 if moments == "int8" else KERNEL): 1}
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    rendered = tstep.render_batch_on_device(batch, dev)
    masks = torch.tensor([[2.0, 0.0, 2.0], [2.0, 2.0, 0.0]], device=dev).reshape(2, 3, 1, 1)
    lk, _, gk = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks)
    lp, _, gp = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks, plain=True)
    assert abs(float(lk) - float(lp)) <= 1e-2 * float(lp)
    for k in gp:
        assert rel_err(gk[k], gp[k]) <= 0.1, k


def test_grad_accum_ema_and_eval_steps_on_the_card(dev):
    """A small model's AMP step with ``grad_accum=2`` and ``ema_decay`` on
    the card: K5, K6a and K7 once per block and micro-batch, the norm kernel
    and K8 once per step (the plain step's optimizer too); the loss, the
    grads (from the first Adam moment) and the BN statistics against the
    plain step; the EMA is d e + (1 - d) p'.  Then ``make_eval_step`` runs
    the serving blocks (K1) and agrees with the same step on a CPU copy."""
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import step as tstep
    from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam

    cfg = small_model(128, 2, 0.3)
    batch = small_batch(3)
    masks = torch.tensor([[1.0, 1.43, 0.0, 1.43], [1.43, 0.0, 1.43, 1.43]],
                         device=dev).reshape(2, 4, 1, 1)
    out = {}
    for plain in (False, True):
        tx = make_fused_adam(3.75e-4)
        state = tstep.init_train_state(init_params(cfg, 0), tx, ema_decay=0.99)
        step = tstep.make_train_step(cfg, tx, ema_decay=0.99, grad_accum=2, plain=plain)
        kernels.reset_launch_counts()
        new, metrics = step(state, batch, drop_path_masks=masks)
        counts = kernels.launch_counts()
        assert counts.pop("adam") == 1 and counts.pop("grad_norm") == 1
        assert counts == ({} if plain else {"train_fwd": 4, "train_bwd_mlp": 4,
                                            "train_bwd_attn": 4})
        for k, e in new["ema_params"].items():
            ref = state["ema_params"][k] * 0.99 + new["params"][k] * (1.0 - 0.99)
            assert torch.allclose(e, ref, rtol=2 ** -22, atol=1e-12), k
        scale = 0.1 * min(1.0, 1.0 / float(metrics["grad_norm"]))
        out[plain] = (float(metrics["loss"]), {k: v / scale for k, v in new["opt_state"].mu.items()},
                      new)
    assert abs(out[False][0] - out[True][0]) <= 1e-2 * out[True][0]
    for k, g in out[True][1].items():
        assert rel_err(out[False][1][k], g) <= 0.1, k
    for k, v in out[True][2]["bn_state"].items():
        assert rel_err(out[False][2]["bn_state"][k], v) <= 2e-2, k

    state = out[False][2]
    kernels.reset_launch_counts()
    loss, heat = tstep.make_eval_step(cfg, return_heatmaps=True)(state, batch)
    assert kernels.launch_counts() == {"block": 2}
    assert heat.is_cuda and heat.dtype == torch.float32 and heat.shape == (4, 17, 64, 48)
    cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
           for k, v in state.items() if k != "opt_state"}
    cpu["step"] = state["step"].cpu()
    ref = tstep.make_eval_step(cfg)(cpu, batch)
    assert abs(float(loss) - float(ref)) <= 2e-2 * float(ref)


# ------------------------------------------------- the detector: D1 and D2

@pytest.mark.parametrize("hw,imgsz,rect", [((1080, 1920), 320, False), ((1080, 1920), 640, True),
                                           ((37, 61), 96, False), ((200, 90), 64, True),
                                           ((481, 641), 320, True)])
def test_letterbox_kernel_bits(dev, hw, imgsz, rect):
    """D1 equals its plain version bit for bit at float32, and at bf16
    after the one rounding; also on a frame that starts off 4 bytes."""
    from easy_vitpose_tpu_torch.detect import yolo
    g = np.random.default_rng(sum(hw))
    base = torch.from_numpy(g.integers(0, 256, (hw[0] * hw[1] * 3 + 1,), dtype=np.uint8)).to(dev)
    geom = yolo.letterbox_geometry(*hw, imgsz, rect=rect)
    for frame in (base[:-1].view(*hw, 3), base[1:].view(*hw, 3)):
        for dt in (torch.float32, torch.bfloat16):
            kernels.reset_launch_counts()
            got = yolo.letterbox_input(frame, geom, dt)
            assert kernels.launch_counts() == {"letterbox": 1}
            ref = yolo.letterbox_input_plain(frame, geom, dt)
            assert got.shape == ref.shape == (1, 3, geom[6], geom[5]) and got.dtype == dt
            assert got.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(got, ref)


def nms_candidates_on(dev, seed, n, max_det, conf_t=0.25, classes=3, ties=False):
    from easy_vitpose_tpu_torch.detect import yolo
    g = np.random.default_rng(seed)
    c = g.uniform(20, 600, (n, 2))
    wh = g.uniform(10, 90, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = g.uniform(0.05, 1.0, n).astype(np.float32)
    if ties:
        scores[::3] = 0.6
    cls = g.integers(0, classes, n).astype(np.int32)
    return yolo.nms_candidates(torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
                               torch.from_numpy(cls).to(dev), conf_t, max_det)


@pytest.mark.parametrize("n,max_det,ties,conf_t", [(2100, 300, False, 0.25), (2100, 300, True, 0.25),
                                                   (150, 300, False, 0.25), (150, 300, True, 0.9),
                                                   (40, 40, False, -1.0), (1000, 1000, True, 0.5)])
@pytest.mark.parametrize("agnostic", [False, True])
def test_nms_kernel_bits(dev, n, max_det, ties, conf_t, agnostic):
    """D2 equals its plain version (JAX's fixpoint) bit for bit on the same
    sorted candidates: k < max_det (zero padding), ties at the -1 fill and
    above the gate, class-aware and agnostic."""
    from easy_vitpose_tpu_torch.detect import yolo
    cand = nms_candidates_on(dev, n + max_det, n, max_det, conf_t, ties=ties)
    kernels.reset_launch_counts()
    got = yolo.nms_packed(*cand, max_det, 0.5, 7, 70, 0.3, class_agnostic=agnostic)
    assert kernels.launch_counts() == {"nms": 1}
    ref = yolo.nms_packed_plain(*cand, max_det, 0.5, 7, 70, 0.3, class_agnostic=agnostic)
    assert got.shape == (max_det, 7) and torch.equal(got, ref)
    kept, valid = int(got[:, 6].sum()), int((cand[1] > 0).sum())
    assert 0 < kept <= valid and (kept < valid or valid < 100)  # dense sets suppress some


def test_nms_kernel_refuses(dev):
    from easy_vitpose_tpu_torch.detect import yolo
    kmax = max(k for k in range(1, 4096) if yolo.nms_smem_bytes(k) <= yolo.SMEM_LIMIT)
    cand = nms_candidates_on(dev, 0, kmax, kmax)
    got = yolo.nms_packed(*cand, kmax, 0.7, 0, 0, 1.0)          # the largest k that fits
    assert torch.equal(got, yolo.nms_packed_plain(*cand, kmax, 0.7, 0, 0, 1.0))
    cand = nms_candidates_on(dev, 0, kmax + 1, kmax + 1)
    with pytest.raises(ValueError, match="shared memory"):
        yolo.nms_packed(*cand, kmax + 1, 0.7, 0, 0, 1.0)
    cand = nms_candidates_on(dev, 0, 50, 50)
    with pytest.raises(ValueError, match="k <= max_det"):
        yolo.nms_packed(*cand, 40, 0.7, 0, 0, 1.0)
    with pytest.raises(ValueError, match="int32"):
        yolo.nms_packed(cand[0], cand[1], cand[2].long(), 50, 0.7, 0, 0, 1.0)


def test_wrappers_raise_when_a_kernel_fails(dev, monkeypatch):
    """A wrapper given CUDA tensors whose launch fails raises; it does not
    fall back to its plain version."""
    from easy_vitpose_tpu_torch.detect import yolo

    def refuse(name, fn, device, *args):
        raise RuntimeError(f"{name}.{fn}: CUDA error 1 (refused)")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    frame = torch.zeros(48, 64, 3, dtype=torch.uint8, device=dev)
    cand = nms_candidates_on(dev, 1, 100, 100)
    monkeypatch.setattr(kernels, "call", refuse)
    monkeypatch.setattr(yolo, "letterbox_input_plain", plain)
    monkeypatch.setattr(yolo, "nms_packed_plain", plain)
    with pytest.raises(RuntimeError, match="letterbox"):
        yolo.letterbox_input(frame, yolo.letterbox_geometry(48, 64, 64))
    with pytest.raises(RuntimeError, match="nms"):
        yolo.nms_packed(*cand, 100, 0.7, 0, 0, 1.0)


def small_files(dev, tmp_path, frame):
    """A small ViTPose (.npz, the JAX layout) and a YOLOv8n (.npz) from
    random weights, and the ViTPose config."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.convert.vitpose_torch import convert_vitpose_state_dict
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.utils.checkpoint import save_params

    cfg = ModelConfig("small", "coco", BackboneConfig(embed_dim=128, depth=2, num_heads=2),
                      HeadConfig(in_channels=128, num_keypoints=17, deconv_filters=(64, 64)))
    pose = str(tmp_path / "vitpose-s-coco.npz")
    save_params(pose, convert_vitpose_state_dict(init_params(cfg, 0).state_dict(), cfg))
    det = str(tmp_path / "yolov8n.npz")
    yolo.save_yolo_npz(det, yolo.init_yolo_params(0, yolo.YoloSpec("n"), frame, 320), "n")
    return pose, det, cfg


def test_detect_frame_core_kernels_equal_plain(dev):
    """The whole detector on the card, D1 and D2 against their plain
    versions on the card: the same packed rows at float32, and at bf16."""
    from easy_vitpose_tpu_torch.detect import yolo
    g = np.random.default_rng(0)
    frame_np = g.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    spec = yolo.YoloSpec("n")
    params = yolo.init_yolo_params(0, spec, frame_np, 320)
    frame = torch.from_numpy(frame_np).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        model = yolo.yolo_params_from_jax(params, spec, dt, dev)
        for rect in (False, True):
            geom = yolo.letterbox_geometry(1080, 1920, 320, rect=rect)
            kernels.reset_launch_counts()
            got = yolo.detect_frame_core(model, frame, geom, spec, 320, (0,), 0.25, 0.7, 300, dt)
            assert kernels.launch_counts() == {"letterbox": 1, "nms": 1}
            ref = yolo.detect_frame_core(model, frame, geom, spec, 320, (0,), 0.25, 0.7, 300, dt,
                                         plain=True)
            assert torch.equal(got, ref)
            assert int(got[:, 6].sum()) > 0


def test_vitinference_frame_queues_without_host_wait(dev, tmp_path):
    """An image-mode detection frame through VitInference on the card:
    detector and pose step queue under PyTorch's synchronisation check set
    to raise, the one fetch outside it; launches per frame; the same
    detections as the plain path."""
    from easy_vitpose_tpu_torch.detect.yolo import letterbox_geometry
    from easy_vitpose_tpu_torch.pipeline.fused_detect import detect_pose
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    pose, det, cfg = small_files(dev, tmp_path, img)
    vi = VitInference(pose, yolo=det, model_name="b", model_cfg=cfg, dtype="int8")
    assert vi.device.type == "cuda" and vi.single_dispatch
    out = vi.inference(img)                                   # first use: builds, caches
    assert all(np.isfinite(k).all() and k.shape == (17, 3) for k in out.values())
    d = vi._detector
    geom = letterbox_geometry(480, 640, d.imgsz, rect=d.rect)
    slots = max(vi._slots_highwater, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.reset_launch_counts()
        frame = vi._upload(img)
        packed, kpts = detect_pose(d.model, vi._model, frame, geom, d.spec, d.imgsz, d.classes,
                                   d.conf, d.iou, d.max_det, d.dtype, slots, vi._gate())
        counts = kernels.launch_counts()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counts == {"letterbox": 1, "nms": 1, "sampler": 1, "block_q8": 2, "decode": 1}
    assert packed.shape == (300, 7) and kpts.shape == (slots, 17, 3)
    plain = VitInference(pose, yolo=det, model_name="b", model_cfg=cfg, dtype="int8", plain=True)
    assert plain.inference(img).keys() == vi.inference(img).keys()
    np.testing.assert_array_equal(plain._yolo_res, vi._yolo_res)


# ------------------------------------------- stacked frames and graph replay

@pytest.mark.parametrize("hw", [(1080, 1920), (1079, 1917), (37, 53)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_stacked_bits(dev, hw, dtype):
    """K3 with a frame index per box: the plain version's bits, and each
    crop its own frame's single-frame crop; (1079, 1917) and (37, 53) make
    H * W * 3 not a multiple of 4, so frames after the first start off a
    word; indices out of range clamp as JAX's gather clamps them."""
    H, W = hw
    S = 4
    g = np.random.default_rng(H)
    frames = torch.from_numpy(g.integers(0, 256, (S, H, W, 3), dtype=np.uint8)).to(dev)
    xy = g.uniform(-30, max(W, H), (20, 2))
    wh = g.uniform(2, max(W, H) / 2, (20, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32)).to(dev)
    fidx = torch.from_numpy(np.r_[g.integers(0, S, 16), [-1, 7, -9, 3]].astype(np.int32)).to(dev)
    kernels.reset_launch_counts()
    got, geo = sampler.crop_normalize(frames, boxes, dtype=dtype, frame_idx=fidx)
    assert kernels.launch_counts() == {"sampler": 1}
    ref, rgeo = sampler.crop_normalize_plain(frames, boxes, dtype=dtype, frame_idx=fidx)
    assert torch.equal(got, ref) and torch.equal(geo, rgeo)
    own = preprocess.clamp_frame_idx(fidx, S).tolist()
    for i in (0, 5, 16, 17, 18):
        one, g1 = sampler.crop_normalize(frames[own[i]], boxes[i:i + 1], dtype=dtype)
        assert torch.equal(got[i:i + 1], one) and torch.equal(geo[i:i + 1], g1)


@pytest.mark.parametrize("hw,imgsz,rect", [((1080, 1920), 320, False), ((1080, 1920), 640, True),
                                           ((37, 61), 96, False)])
def test_letterbox_stacked_bits(dev, hw, imgsz, rect):
    from easy_vitpose_tpu_torch.detect import yolo
    S = 3
    g = np.random.default_rng(sum(hw))
    frames = torch.from_numpy(g.integers(0, 256, (S, *hw, 3), dtype=np.uint8)).to(dev)
    geom = yolo.letterbox_geometry(*hw, imgsz, rect=rect)
    for dt in (torch.float32, torch.bfloat16):
        kernels.reset_launch_counts()
        got = yolo.letterbox_input(frames, geom, dt)
        assert kernels.launch_counts() == {"letterbox": 1}
        assert got.shape == (S, 3, geom[6], geom[5])
        assert torch.equal(got, yolo.letterbox_input_plain(frames, geom, dt))
        for s in range(S):
            assert torch.equal(got[s:s + 1], yolo.letterbox_input(frames[s], geom, dt))


def test_nms_stacked_bits(dev):
    """D2 over (S, k) candidates, one block per frame: the plain version's
    rows and each frame's single-frame launch, frames of few and of many
    valid candidates side by side."""
    from easy_vitpose_tpu_torch.detect import yolo
    sets = [nms_candidates_on(dev, s, n, 300, conf_t=c, ties=bool(s % 2))
            for s, (n, c) in enumerate([(2100, 0.25), (400, 0.9), (2100, 0.5), (300, -1.0)])]
    cand = [torch.stack([s[i] for s in sets]) for i in range(3)]
    kernels.reset_launch_counts()
    got = yolo.nms_packed(*cand, 300, 0.5, 7, 70, 0.3)
    assert kernels.launch_counts() == {"nms": 1} and got.shape == (4, 300, 7)
    assert torch.equal(got, yolo.nms_packed_plain(*cand, 300, 0.5, 7, 70, 0.3))
    for s in range(4):
        assert torch.equal(got[s], yolo.nms_packed(*sets[s], 300, 0.5, 7, 70, 0.3))


def test_graph_replay_equals_eager(dev, tmp_path):
    """VitInference's detection frame and the detector's programs as CUDA
    graph replays: the eager program's bits, the captured launches counted
    at each replay, no host sync in capture or replay."""
    from easy_vitpose_tpu_torch.pipeline.fused_detect import detect_pose, detect_pose_multi
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    pose, det, cfg = small_files(dev, tmp_path, img)
    vi = VitInference(pose, yolo=det, model_name="b", model_cfg=cfg, dtype="int8")
    for _ in range(3):
        vi.inference(img)                     # warm-up, capture, replay
    d = vi._detector
    geom, slots, gate = d.geometry((480, 640)), vi._slots_highwater, vi._gate()
    frame = vi._upload(img)
    key = ("detect_pose", tuple(frame.shape), slots, gate)
    assert d.graphs.launches(key) == {"letterbox": 1, "nms": 1, "sampler": 1, "block_q8": 2,
                                      "decode": 1}
    kernels.reset_launch_counts()
    out = vi.inference(img)
    assert kernels.launch_counts() == d.graphs.launches(key)
    eager = detect_pose(d.model, vi._model, frame, geom, d.spec, d.imgsz, d.classes, d.conf,
                        d.iou, d.max_det, d.dtype, slots, gate)
    replay = d.graphs.run(key, None, frame)
    for a, b in zip(replay, eager):
        assert torch.equal(a, b)
    assert out.keys() == vi.inference(img).keys()
    frames = torch.from_numpy(np.stack([img, np.roll(img, 8, 1)])).to(dev)
    for _ in range(3):
        packed = d.detect_batch_async(frames)
    assert torch.equal(packed, yolo_batch(d, frames))

    def multi(f):
        return detect_pose_multi(d.model, vi._model, f, geom, d.spec, d.classes, d.conf, d.iou,
                                 d.max_det, d.dtype, 4, gate)

    for _ in range(3):
        got = d.graphs.run(("multi", tuple(frames.shape)), multi, frames)
    for a, b in zip(got, multi(frames)):
        assert torch.equal(a, b)


def yolo_batch(d, frames):
    from easy_vitpose_tpu_torch.detect import yolo
    return yolo.detect_batch_core(d.model, frames, d.geometry(tuple(frames.shape[1:3])), d.spec,
                                  d.classes, d.conf, d.iou, d.max_det, d.dtype)
