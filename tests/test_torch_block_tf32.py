"""PyTorch port: K1's float32 flavor on the tensor cores (3xTF32).

The kernels (``csrc/gemm_tf32.cuh``, ``csrc/attention_tf32.cuh``) run only
on the card; here the CPU holds what they rest on:

* the split helper, bit for bit on crafted float32 patterns against an
  independent round-to-nearest-away reference in float64, with its
  properties (``hi``'s low 13 bits zero, ``|x - hi - lo| <= 2^-22 |x|``);
* the algorithm: a block whose every product is split and summed in three
  TF32 passes as the kernels do, at ViT-B width, against JAX's float32 XLA
  block within the card's block bounds (chip_smoke.py's ``TOL["fp32"]``
  1e-4 and ``UPDATE_TOL["fp32"]`` 1e-5);
* the shape rules of the float32 GEMM and attention, and the scope that
  keeps the fp32 path's convolutions float32 and deterministic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.models.vit import block as jax_block
from easy_vitpose_tpu_torch.models import fused_block as fb
from easy_vitpose_tpu_torch.models import vit
from easy_vitpose_tpu_torch.utils.precision import float32_convolutions, tf32_check_floats

torch.set_num_threads(1)
BLOCK_TOL, UPDATE_TOL = 1e-4, 1e-5      # chip_smoke.py's TOL["fp32"], UPDATE_TOL["fp32"]
TF32_MAX = (2.0 - 2.0 ** -10) * 2.0 ** 127


def rna_reference(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 (10 fraction bits), nearest with ties away from
    zero, by exact float64 arithmetic: a magnitude past TF32's largest
    rounds to infinity, subnormals keep TF32's 2^-136 spacing, infinities
    stay, NaNs become 0x7FC00000."""
    out = np.empty(x.shape, np.float32)
    with np.errstate(invalid="ignore"):             # a signalling NaN's cast
        wide = x.astype(np.float64)
    for i, v in enumerate(wide):
        if np.isnan(v):
            out[i] = np.uint32(0x7FC00000).view(np.float32)
            continue
        if np.isinf(v) or v == 0.0:
            out[i] = v
            continue
        e = max(int(np.floor(np.log2(abs(v)))), -126)
        ulp = 2.0 ** (e - 10)
        r = np.floor(abs(v) / ulp + 0.5) * ulp
        out[i] = np.copysign(np.inf if r > TF32_MAX else r, v)
    return out


@pytest.fixture(scope="module")
def patterns():
    x = tf32_check_floats()
    return x, fb.tf32_split_plain(torch.from_numpy(x))


def test_split_rounds_to_nearest_away(patterns):
    """``hi`` is rna(x) bit for bit and has its low 13 bits zero; ``lo`` is
    rna(x - hi), zero where x is not finite."""
    x, (hi, lo) = patterns
    hib = hi.numpy().view(np.uint32)
    assert not (hib & 0x1FFF).any()
    assert np.array_equal(hib, rna_reference(x).view(np.uint32))
    finite = np.isfinite(x)
    with np.errstate(invalid="ignore", over="ignore"):
        want_lo = np.where(finite, rna_reference((x - hi.numpy()).astype(np.float32)), 0.0)
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.astype(np.float32).view(np.uint32))
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()


def test_split_ties_go_away_from_zero(patterns):
    x, (hi, _) = patterns
    bits, hib = x.view(np.uint32), hi.numpy().view(np.uint32)
    for b, want in ((0x3F801000, 0x3F802000), (0xBF801000, 0xBF802000),
                    (0x3F800FFF, 0x3F800000), (0x3FFFF000, 0x40000000),
                    (0x7F7FFFFF, 0x7F800000), (0x007FFFFF, 0x00800000),
                    (0x00001000, 0x00002000), (0x00000FFF, 0x00000000)):
        assert hib[np.flatnonzero(bits == b)[0]] == want, hex(b)


def test_split_error_bound(patterns):
    """|x - hi - lo| <= 2^-22 |x|, or half of TF32's smallest step (2^-137)
    where lo falls below TF32's normal range, for every finite x whose hi
    is finite."""
    x, (hi, lo) = patterns
    ok = np.isfinite(x) & np.isfinite(hi.numpy())
    v = x[ok].astype(np.float64)
    h, l_ = hi.numpy()[ok].astype(np.float64), lo.numpy()[ok].astype(np.float64)
    err = np.abs(v - h - l_)
    assert (err <= np.maximum(2.0 ** -22 * np.abs(v), 2.0 ** -137)).all()
    big = np.abs(v) >= 2.0 ** -100
    assert (err[big] <= 2.0 ** -22 * np.abs(v[big])).all() and big.sum() > 3000


def test_split_on_the_cpu_is_the_plain_split():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32))
    got, want = fb.tf32_split(w), fb.tf32_split_plain(w)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


# ------------------------------------------------------- the algorithm
def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T as the kernels form it: each operand split, the three
    passes lo.hi + hi.lo + hi.hi (each an exact product of 11-bit numbers
    summed in float32), the small ones first."""
    ah, al = fb.tf32_split_plain(a)
    bh, bl = fb.tf32_split_plain(b)
    return (al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2)) + ah @ bh.transpose(-1, -2)


def emulated_block(x: torch.Tensor, w: vit.BlockWeights, heads: int, eps: float):
    """K1 fp32's arithmetic on the CPU: LN, the four linears and attention's
    two products in three TF32 passes, the softmax, GELU and residuals in
    float32."""
    B, N, D = x.shape
    hd = D // heads
    h = vit.layer_norm(x, w.ln1_w, w.ln1_b, eps)
    qkv = tf32_product(h, w.qkv_w) + w.qkv_b
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = tf32_product(q * vit.q_scale(hd, torch.float32), k)
    p = torch.softmax(s, dim=-1)
    o = tf32_product(p, v.transpose(-1, -2)).transpose(1, 2).reshape(B, N, D)
    x1 = x + (tf32_product(o, w.proj_w) + w.proj_b)
    m = vit.gelu(tf32_product(vit.layer_norm(x1, w.ln2_w, w.ln2_b, eps), w.fc1_w) + w.fc1_b)
    return x1 + (tf32_product(m, w.fc2_w) + w.fc2_b)


def update_err(got: np.ndarray, ref: np.ndarray, x: np.ndarray) -> float:
    """chip_smoke.py's update error: |got - ref| beyond two float32 ulps of
    ref, over the largest update ref - x."""
    ulp = np.ldexp(np.ones_like(ref), np.frexp(ref)[1] - 24)
    excess = np.clip(np.abs(got - ref) - 2 * ulp, 0, None)
    return float(excess.max()) / float(np.abs(ref - x).max())


@pytest.fixture(scope="module")
def vit_b_block():
    """Random ViT-B block 0 weights (D 768, 12 heads, hidden 3072) as the
    model's init draws them, and 2 crops of 192 tokens."""
    g = np.random.default_rng(17)
    D, H = 768, 3072
    f = lambda *s, sc=0.02: (g.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    layer = {"ln1_s": 1 + f(D, sc=0.1), "ln1_b": f(D, sc=0.1), "qkv_w": f(D, 3 * D),
             "qkv_b": f(3 * D, sc=0.1), "proj_w": f(D, D), "proj_b": f(D, sc=0.1),
             "ln2_s": 1 + f(D, sc=0.1), "ln2_b": f(D, sc=0.1),
             "mlp": {"fc1_w": f(D, H), "fc1_b": f(H, sc=0.1), "fc2_w": f(H, D),
                     "fc2_b": f(D, sc=0.1)}}
    x = g.standard_normal((2, 192, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    m = layer["mlp"]
    w = vit.BlockWeights(t(layer["ln1_s"]), t(layer["ln1_b"]), t(layer["qkv_w"].T),
                         t(layer["qkv_b"]), t(layer["proj_w"].T), t(layer["proj_b"]),
                         t(layer["ln2_s"]), t(layer["ln2_b"]), t(m["fc1_w"].T), t(m["fc1_b"]),
                         t(m["fc2_w"].T), t(m["fc2_b"]))
    ref = np.asarray(jax.jit(jax_block, static_argnums=(2, 3))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, layer), 12, 1e-6))
    return x, w, ref


def test_emulated_3xtf32_block_meets_the_cards_bounds(vit_b_block):
    """The 3xTF32 block against JAX's float32 XLA block: within TOL["fp32"]
    of the largest output and UPDATE_TOL["fp32"] of the largest update."""
    x, w, ref = vit_b_block
    got = emulated_block(torch.from_numpy(x), w, 12, 1e-6).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= BLOCK_TOL, rel
    assert update_err(got, ref, x) <= UPDATE_TOL


def test_one_tf32_pass_misses_the_bounds(vit_b_block):
    """The reason for three passes: hi.hi alone (plain TF32) misses the
    update bound by far."""
    x, w, ref = vit_b_block
    one = lambda a, b: fb.tf32_split_plain(a).hi @ fb.tf32_split_plain(b).hi.T  # noqa: E731
    h = vit.layer_norm(torch.from_numpy(x), w.ln1_w, w.ln1_b, 1e-6)
    qkv = tf32_product(h, w.qkv_w) + w.qkv_b
    o = vit.attention_core(qkv, 12)
    x1 = torch.from_numpy(x) + one(o, w.proj_w) + w.proj_b
    m = vit.gelu(one(vit.layer_norm(x1, w.ln2_w, w.ln2_b, 1e-6), w.fc1_w) + w.fc1_b)
    got = (x1 + one(m, w.fc2_w) + w.fc2_b).numpy()
    assert update_err(got, ref, x) > 10 * UPDATE_TOL


# ------------------------------------------------------- the shape rules
@pytest.mark.parametrize("K", [384, 768, 1024, 1280, 1536, 3072, 4096, 5120])
def test_gemm_shape_takes_every_vit_depth_at_float32(K):
    fb.check_gemm_shape(768, K, 4)


@pytest.mark.parametrize("N,K,match", [(768, 16, "depth 16 is not a multiple of 32"),
                                       (768, 80, "depth 80 is not a multiple of 32"),
                                       (96, 768, "width 96 is not a multiple of 64")])
def test_gemm_shape_refuses_off_tile_float32_shapes(N, K, match):
    with pytest.raises(ValueError, match=match):
        fb.check_gemm_shape(N, K, 4)


@pytest.mark.parametrize("N,hd,ok", [(192, 64, True), (192, 80, True), (256, 96, True),
                                     (256, 128, False), (192, 20, False), (192, 136, False)])
def test_float32_attention_shapes(N, hd, ok):
    """The float32 attention takes a head dim that is a multiple of 8 up to
    128 whose K and V fit in shared memory (ViT-S/B/L/H: 32, 64, 64, 80)."""
    if ok:
        fb.check_attention_shape(N, 2 * hd, 2, torch.float32)
        assert fb.attention_smem_bytes(N, hd) <= fb.SMEM_LIMIT
    else:
        with pytest.raises(ValueError, match="float32 attention|shared memory"):
            fb.check_attention_shape(N, 2 * hd, 2, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float32_convolution_scope(dtype):
    """cuDNN's TF32 flag is off and its deterministic algorithms on inside
    the scope for float32 only, and the caller's settings come back, also
    after an exception."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    f32 = dtype == torch.float32
    try:
        for tf32, det in ((True, False), (False, True), (True, True)):
            cudnn.allow_tf32, cudnn.deterministic = tf32, det
            with float32_convolutions(dtype):
                assert cudnn.allow_tf32 == (tf32 and not f32)
                assert cudnn.deterministic == (det or f32)
            assert (cudnn.allow_tf32, cudnn.deterministic) == (tf32, det)
            with pytest.raises(KeyError):
                with float32_convolutions(dtype):
                    raise KeyError
            assert (cudnn.allow_tf32, cudnn.deterministic) == (tf32, det)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev
