"""PyTorch port: the training block (K5 forward, K6a + K7 backward) against
the JAX package's custom-VJP fused block in interpret mode and jax.vjp of
its XLA block.

On the CPU :class:`FusedBlockTrain` runs the kernels' plain versions, which
these tests hold; the kernels are held to the plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.  The block is D=64 with two
heads (head_dim 32, where the softmax scale is not exact in bf16), 192
tokens, three crops of which one is dropped (keep 0) and two kept at
1/keep_prob = 1.25; every parameter is random, so each grad term counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig
from easy_vitpose_tpu.models.fused_block_train import make_fused_block_train
from easy_vitpose_tpu.models.vit import block as jax_block
from easy_vitpose_tpu_torch.models import fused_block_train as fbt
from easy_vitpose_tpu_torch.models.vit import BlockWeights, block_train

torch.set_num_threads(1)
CFG = BackboneConfig(embed_dim=64, depth=1, num_heads=2)
KEEP = np.array([1.25, 0.0, 1.25], np.float32)
# JAX layer key -> (port BlockWeights field, transpose)
LAYOUT = [("ln1_s", "ln1_w", False), ("ln1_b", "ln1_b", False), ("qkv_w", "qkv_w", True),
          ("qkv_b", "qkv_b", False), ("proj_w", "proj_w", True), ("proj_b", "proj_b", False),
          ("ln2_s", "ln2_w", False), ("ln2_b", "ln2_b", False), ("fc1_w", "fc1_w", True),
          ("fc1_b", "fc1_b", False), ("fc2_w", "fc2_w", True), ("fc2_b", "fc2_b", False)]


def _get(tree, key):
    return tree["mlp"][key] if key.startswith("fc") else tree[key]


def random_layer(seed=0, D=64, H=256):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc: (rng.standard_normal(s) * sc).astype(np.float32)
    return {"ln1_s": 1 + n(D, sc=0.1), "ln1_b": n(D, sc=0.05), "qkv_w": n(D, 3 * D, sc=0.15),
            "qkv_b": n(3 * D, sc=0.05), "proj_w": n(D, D, sc=0.1), "proj_b": n(D, sc=0.05),
            "ln2_s": 1 + n(D, sc=0.1), "ln2_b": n(D, sc=0.05),
            "mlp": {"fc1_w": n(D, H, sc=0.1), "fc1_b": n(H, sc=0.05),
                    "fc2_w": n(H, D, sc=0.06), "fc2_b": n(D, sc=0.05)}}


def port_weights(layer, dtype) -> BlockWeights:
    return BlockWeights(**{f: torch.from_numpy(np.ascontiguousarray(
        _get(layer, k).T if t else _get(layer, k))).to(dtype) for k, f, t in LAYOUT})


def cotangent(shape):
    return np.sin(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def jax_vjp(fn, x, layer, dtype):
    out, vjp = jax.vjp(fn, jnp.asarray(x, dtype), jax.tree.map(lambda a: jnp.asarray(a, dtype), layer))
    gx, gp = vjp(jnp.asarray(cotangent(out.shape), dtype))
    grads = [np.asarray(_get(gp, k), np.float32) for k, _, _ in LAYOUT]
    grads = [g.T if t else g for g, (_, _, t) in zip(grads, LAYOUT)]
    return np.asarray(out, np.float32), np.asarray(gx, np.float32), grads


def port_vjp(fn, x, w: BlockWeights):
    xt = x.clone().requires_grad_(True)
    wt = [t.clone().requires_grad_(True) for t in w]
    out = fn(xt, BlockWeights(*wt))
    out.backward(torch.from_numpy(cotangent(out.shape)).to(out.dtype))
    return (out.detach().float().numpy(), xt.grad.float().numpy(),
            [t.grad.float().numpy() for t in wt])


def rel(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


@pytest.fixture(scope="module")
def case():
    x = np.random.default_rng(1).standard_normal((3, CFG.num_tokens, 64)).astype(np.float32)
    return x, random_layer()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_vjp_matches_jax_fused_kernels(case, dtype):
    """Forward, dx and every weight grad of the port's training block against
    the JAX custom VJP (Pallas interpret).  float32: same math, sums in
    another order (1e-5 of each tensor's largest value, the weight grads
    summed over 576 rows 2e-5).  bf16: the same roundings at the same
    points, where sums in another order may flip one; 2e-2.  The dropped
    crop's input gradient is its output gradient in both, bit for bit."""
    x, layer = case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fused = make_fused_block_train(CFG, interpret=True)
    keep = jnp.asarray(KEEP)
    out_j, gx_j, gw_j = jax_vjp(lambda xx, pp: fused(xx, pp, keep), x, layer, jdt)
    out_p, gx_p, gw_p = port_vjp(
        lambda xx, w: fbt.fused_block_train(xx, torch.from_numpy(KEEP), w, 2, CFG.layer_norm_eps),
        torch.from_numpy(x).to(tdt), port_weights(layer, tdt))
    tol, wtol = (1e-5, 2e-5) if dtype == "float32" else (2e-2, 2e-2)
    assert rel(out_p, out_j) <= tol
    assert rel(gx_p, gx_j) <= tol
    np.testing.assert_array_equal(gx_p[1], gx_j[1])     # the dropped crop: dx = dout
    for (k, _, _), gp, gj in zip(LAYOUT, gw_p, gw_j):
        assert rel(gp, gj) <= wtol, k


def test_block_vjp_matches_jax_xla_block_and_port_autograd(case):
    """float32: the port's training block against jax.vjp of the JAX XLA
    block (exact erf vs the kernels' A&S erf: the bound of
    tests/test_fused_block_train.py, 2e-4 / 3e-4 of the largest value), and
    against autograd of the port's own XLA block (:func:`block_train`)."""
    x, layer = case
    keep_j = jnp.asarray(KEEP)[:, None, None]
    ref = jax_vjp(lambda xx, pp: jax_block(xx, pp, 2, CFG.layer_norm_eps, drop_path_keep=keep_j),
                  x, layer, jnp.float32)
    w = port_weights(layer, torch.float32)
    fused = port_vjp(lambda xx, ww: fbt.fused_block_train(xx, torch.from_numpy(KEEP), ww, 2,
                                                          CFG.layer_norm_eps),
                     torch.from_numpy(x), w)
    xla = port_vjp(lambda xx, ww: block_train(xx, ww, 2, CFG.layer_norm_eps,
                                              torch.from_numpy(KEEP)[:, None, None]),
                   torch.from_numpy(x), w)
    for got in (fused, xla):
        assert rel(got[0], ref[0]) <= 2e-5
        assert rel(got[1], ref[1]) <= 2e-4
        for (k, _, _), gp, gj in zip(LAYOUT, got[2], ref[2]):
            assert rel(gp, gj) <= 3e-4, k
    # the port's XLA block is JAX's XLA block: exact erf on both sides
    assert rel(xla[1], ref[1]) <= 1e-5


def test_dropped_crop_passes_the_gradient_through(case):
    """A crop with keep 0 skips both branches: its output is its input and
    its input grad the output grad, bit for bit, in the plain versions."""
    x, layer = case
    out, gx, _ = port_vjp(lambda xx, w: fbt.fused_block_train(
        xx, torch.from_numpy(KEEP), w, 2, CFG.layer_norm_eps), torch.from_numpy(x),
        port_weights(layer, torch.float32))
    np.testing.assert_array_equal(out[1], x[1])
    np.testing.assert_array_equal(gx[1], cotangent(out.shape)[1])


def test_plain_versions_split_like_the_kernels(case):
    """The plain K6a and K7 compose to the block's VJP, and the attention
    backward core agrees with autograd of the forward attention at float32."""
    x, layer = case
    w = port_weights(layer, torch.float32)
    xt, keep = torch.from_numpy(x), torch.from_numpy(KEEP)
    out, x1, _, _ = fbt.train_forward_plain(xt, keep, w, 2, CFG.layer_norm_eps)
    dout = torch.from_numpy(cotangent(out.shape))
    dx1, gm = fbt.mlp_backward_plain(x1, dout, keep, w, CFG.layer_norm_eps)
    dx, ga = fbt.attn_backward_plain(xt, dx1, keep, w, 2, CFG.layer_norm_eps)
    assert all(g.dtype == torch.float32 for g in gm + ga)
    assert gm[0].shape == w.fc1_w.shape and ga[0].shape == w.qkv_w.shape

    from easy_vitpose_tpu_torch.models.vit import attention_core
    qkv = torch.randn(2, 192, 3 * 64, generator=torch.Generator().manual_seed(0))
    do = torch.randn(2, 192, 64, generator=torch.Generator().manual_seed(1))
    qa = qkv.clone().requires_grad_(True)
    attention_core(qa, 2).backward(do)
    o, dqkv = fbt.attention_backward_core(qkv, do, 2)
    np.testing.assert_allclose(o.numpy(), attention_core(qkv, 2).numpy(), atol=1e-6)
    assert rel(dqkv.numpy(), qa.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("which", ["nt_a", "nn_b", "aux"])
def test_train_gemm_refuses_misaligned_operands(which):
    """The bf16 GEMM reads its operands and epilogue inputs by TMA, which
    needs each to start at a multiple of 16 bytes: a view 8 bytes into its
    storage is refused in Python before any launch, here on the CPU too
    (the TN pair's check runs after its CUDA check; the card tests it)."""
    def mat(r, c, dtype=torch.bfloat16, off=0):
        return torch.zeros(r * c + off, dtype=dtype)[off:].view(r, c)

    bad = 4       # elements: 8 bytes at bf16, 16 at float32
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        if which == "nt_a":
            fbt.gemm_nt(mat(16, 16, off=bad), mat(8, 16), fbt.TE_NONE)
        elif which == "nn_b":
            fbt.gemm_nn(mat(16, 16), mat(16, 8, off=bad), fbt.TE_NONE)
        else:
            fbt.gemm_nn(mat(16, 16), mat(16, 8), fbt.TE_GELU_GRAD,
                        aux=mat(16, 8, torch.float32, off=bad // 2))
