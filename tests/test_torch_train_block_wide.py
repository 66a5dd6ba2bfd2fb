"""PyTorch port: the wide MLP backward (K6b then K6c, D > 768) against the
JAX package's saved-operand wide kernels in interpret mode.

At ViT-L's width (D=1024, 16 heads of 64, hidden 4096) with two crops, one
kept at 1/keep_prob = 2 and one dropped (drop-path 0.5, ViT-L's rate),
192 tokens each.  JAX's ``_mlp_backward_padded`` picks, at D = 1024 and
with ``EVT_TRAIN_WIDE`` unset, the saved-operand pair
``_bwd_mlp_dx_save_kernel`` + ``_bwd_mlp_dw_saved_kernel`` with the hidden
dim in two chunks; the port's plain K6b and K6c (what the wrappers run on
the CPU) are held to its seven outputs, and to the port's own K6a, which
computes the same function in one piece.  Weights are random with the
matrices scaled by 1/sqrt(D), so the logits stay in softmax's working range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.configs import BackboneConfig
from easy_vitpose_tpu.models.fused_block_train import _mlp_backward_padded, make_fused_block_train
from easy_vitpose_tpu_torch.models import fused_block_train as fbt
from tests.test_torch_train_block import LAYOUT, jax_vjp, port_vjp, port_weights, rel

torch.set_num_threads(2)
D, HEADS, HIDDEN, B = 1024, 16, 4096, 2
CFG = BackboneConfig(embed_dim=D, depth=1, num_heads=HEADS)
N = CFG.num_tokens
KEEP = np.array([2.0, 0.0], np.float32)
# the seven outputs of _mlp_backward_padded; JAX's (in, out) weight grads transposed
OUTPUTS = ("dx1", "dW1", "db1", "dW2", "db2", "dln2_w", "dln2_b")


def wide_layer(seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    w = 1.0 / np.sqrt(D)
    return {"ln1_s": 1 + n(D, sc=0.1), "ln1_b": n(D, sc=0.05), "qkv_w": n(D, 3 * D, sc=w),
            "qkv_b": n(3 * D, sc=0.05), "proj_w": n(D, D, sc=w), "proj_b": n(D, sc=0.05),
            "ln2_s": 1 + n(D, sc=0.1), "ln2_b": n(D, sc=0.05),
            "mlp": {"fc1_w": n(D, HIDDEN, sc=w), "fc1_b": n(HIDDEN, sc=0.05),
                    "fc2_w": n(HIDDEN, D, sc=0.5 / np.sqrt(HIDDEN)), "fc2_b": n(D, sc=0.05)}}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1)
    x1 = rng.standard_normal((B, N, D)).astype(np.float32)
    dout = (rng.standard_normal((B, N, D)) * 0.1).astype(np.float32)
    return x1, dout, wide_layer()


def jax_wide(x1, dout, layer, dtype):
    out = _mlp_backward_padded(jnp.asarray(x1, dtype), jnp.asarray(dout, dtype),
                               jnp.asarray(KEEP)[:, None],
                               jax.tree.map(lambda a: jnp.asarray(a, dtype), layer), CFG, B,
                               interpret=True)
    out = [np.asarray(o, np.float32) for o in out]
    return {"dx1": out[0], "dW1": out[1].T, "db1": out[2][0], "dW2": out[3].T, "db2": out[4][0],
            "dln2_w": out[5][0], "dln2_b": out[6][0]}


def port_wide(x1, dout, layer, tdt):
    w = port_weights(layer, tdt)
    x1t, doutt = torch.from_numpy(x1).to(tdt), torch.from_numpy(dout).to(tdt)
    keep = torch.from_numpy(KEEP)
    dx1, h2, dm2c, dm1c, g, db1, db2, dln_w, dln_b = fbt.mlp_backward_dx_save(
        x1t, doutt, keep, w, CFG.layer_norm_eps)
    assert [tuple(t.shape) for t in (h2, dm2c, dm1c, g)] == [(B * N, D), (B * N, D),
                                                            (B * N, HIDDEN), (B * N, HIDDEN)]
    assert all(t.dtype == tdt for t in (dx1, h2, dm2c, dm1c, g, db1, db2, dln_w, dln_b))
    dW1, dW2 = fbt.mlp_backward_dw_saved(h2, dm2c, dm1c, g)
    got = dict(zip(OUTPUTS, (dx1, dW1, db1, dW2, db2, dln_w, dln_b)))
    ref = fbt.mlp_backward(x1t, doutt, keep, w, CFG.layer_norm_eps)
    ref = dict(zip(OUTPUTS, (ref[0], *ref[1])))
    for k in OUTPUTS:            # K6b + K6c is K6a, bit for bit
        assert torch.equal(got[k], ref[k]), k
    return {k: v.float().numpy() for k, v in got.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_mlp_backward_matches_jax_saved_operand_kernels(case, dtype, monkeypatch):
    """All seven outputs, each relative to its largest value.  float32: the
    same math with sums in another order (1e-5; the weight grads sum 384
    rows).  bf16: the same roundings at the same points, where a sum in
    another order may flip one (1e-2).  The dropped crop's dx1 is its dout,
    bit for bit."""
    monkeypatch.delenv("EVT_TRAIN_WIDE", raising=False)
    x1, dout, layer = case
    ref = jax_wide(x1, dout, layer, getattr(jnp, dtype))
    got = port_wide(x1, dout, layer, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for k in OUTPUTS:
        assert got[k].shape == ref[k].shape, k
        assert rel(got[k], ref[k]) <= tol, (k, rel(got[k], ref[k]))
    np.testing.assert_array_equal(got["dx1"][1], ref["dx1"][1])


def test_block_train_at_vit_l_width_matches_jax(case, monkeypatch):
    """:class:`FusedBlockTrain` forward and backward at D = 1024, where its
    backward takes K6b then K6c, against JAX's custom VJP (Pallas interpret,
    the wide saved-operand MLP backward), float32: 1e-5 of each tensor's
    largest value, the weight grads 2e-5 (as the narrow block's test)."""
    monkeypatch.delenv("EVT_TRAIN_WIDE", raising=False)
    x, _, layer = case
    fused = make_fused_block_train(CFG, interpret=True)
    keep = jnp.asarray(KEEP)
    out_j, gx_j, gw_j = jax_vjp(lambda xx, pp: fused(xx, pp, keep), x, layer, jnp.float32)
    out_p, gx_p, gw_p = port_vjp(
        lambda xx, w: fbt.fused_block_train(xx, torch.from_numpy(KEEP), w, HEADS,
                                            CFG.layer_norm_eps),
        torch.from_numpy(x), port_weights(layer, torch.float32))
    assert rel(out_p, out_j) <= 1e-5 and rel(gx_p, gx_j) <= 1e-5
    np.testing.assert_array_equal(gx_p[1], gx_j[1])
    for (k, _, _), gp, gj in zip(LAYOUT, gw_p, gw_j):
        assert rel(gp, gj) <= 2e-5, k
