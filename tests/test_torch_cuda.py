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
from easy_vitpose_tpu_torch.ops import modulate, preprocess, sampler

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
@pytest.mark.parametrize("M", [1, 100, 1000])
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
def test_gemm_q8(dev, out_dtype, epi):
    M, K, N = 300, 384, 128
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rowquant_bit_equal(dev, dtype):
    h = randn(dev, 77, 3072, scale=3.0, dtype=dtype)
    h[5] = 0
    q, s = quant.rowquant_cuda(h)
    rq, rs = quant.quant_rows(h)
    assert torch.equal(q, rq) and torch.equal(s, rs[:, 0])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("N", [50, 192, 200])
def test_attention(dev, dtype, tol, N):
    B, heads, hd = 3, 2, 64
    qkv = randn(dev, B * N, 3 * heads * hd, dtype=dtype)
    got = fb.attention_cuda(qkv, B, N, heads)
    ref = vit.attention_core(qkv.reshape(B, N, -1), heads).reshape(B * N, -1)
    assert rel_err(got, ref) <= tol


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
    geo = preprocess.crop_geometry(boxes, (H, W))
    for dtype in (torch.float32, torch.bfloat16):
        got = sampler.sample_normalize(frame, geo, dtype=dtype)
        assert torch.equal(got, sampler.sample_normalize_plain(frame, geo, dtype=dtype))


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


def test_pose_step_from_numpy(dev):
    """The user's entry point with numpy inputs runs on the card, through
    every kernel once per layer, and agrees with the plain path."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_heatmaps, pose_step

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
        assert kernels.launch_counts() == {block: 2, "sampler": 1, "modulate": 1}
        assert kp.is_cuda and torch.isfinite(kp).all() and (kp[1] == 0).all()
        with torch.no_grad():
            t = [torch.from_numpy(a).to(dev) for a in (frame, boxes)]
            hk, _ = pose_heatmaps(sm, *t)
            hp, _ = pose_heatmaps(sm, *t, plain=True)
        span = float(hp.max() - hp.min())
        assert float((hk - hp).abs().max()) <= (1e-4 if dtype == "fp32" else 0.05) * span


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
