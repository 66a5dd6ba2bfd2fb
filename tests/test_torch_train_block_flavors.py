"""PyTorch port: the training block's opt-in flavors (saved qkv, saved m)
against the JAX package's Pallas kernels in interpret mode.

The block of tests/test_torch_train_block.py: D=64, two heads, hidden 256,
192 tokens, three crops of which one is dropped.  ``EVT_TRAIN_ATTN=saved``
makes the forward save its qkv for K7 ``_saved``; ``EVT_TRAIN_MLP=saved``
saves the pre-GELU ``m`` (rounded to the working dtype) for K6a ``_ms``.
On the CPU the port's wrappers take the plain versions, which these tests
hold; chip_smoke.py and tests/test_torch_cuda.py hold the kernels to them.
Tolerances are those of test_torch_train_block.py: float32 1e-5 of each
tensor's largest value (the weight grads 2e-5), bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.models.fused_block_train import (_attn_backward_padded,
                                                       _fused_train_fwd_impl,
                                                       _mlp_backward_padded,
                                                       make_fused_block_train)
from easy_vitpose_tpu_torch.models import fused_block_train as fbt
from tests.test_torch_train_block import (CFG, KEEP, LAYOUT, cotangent, jax_vjp, port_vjp,
                                          port_weights, random_layer, rel)

torch.set_num_threads(1)
EPS, HEADS, B = CFG.layer_norm_eps, 2, 3
TOL = {"float32": (1e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
ENV = ("EVT_TRAIN_ATTN", "EVT_TRAIN_MLP", "EVT_TRAIN_WIDE")


@pytest.fixture(autouse=True)
def default_flavors(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, CFG.num_tokens, 64)).astype(np.float32)
    dx1 = (rng.standard_normal((B, CFG.num_tokens, 64)) * 0.1).astype(np.float32)
    return x, dx1, random_layer(3)


def jax_layer(layer, jdt):
    return jax.tree.map(lambda a: jnp.asarray(a, jdt), layer)


def jax_forward(x, layer, jdt, monkeypatch):
    """JAX's K5 with both saves on: (out, x1, qkv, m) as float32 numpy,
    the padded rows cut."""
    monkeypatch.setenv("EVT_TRAIN_ATTN", "saved")
    monkeypatch.setenv("EVT_TRAIN_MLP", "saved")
    outs = _fused_train_fwd_impl(jnp.asarray(x, jdt), jnp.asarray(KEEP), jax_layer(layer, jdt),
                                 CFG, interpret=True)
    return [np.array(o[:B], np.float32) for o in outs]


def port_layout(outs):
    """JAX's seven backward outputs in the port's layout: the (in, out)
    weight grads transposed (the vector grads are reshaped where compared)."""
    outs = [np.asarray(o, np.float32) for o in outs]
    return [outs[0], outs[1].T, outs[2], outs[3].T, *outs[4:]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_saves_qkv_and_m_like_jax(case, dtype, monkeypatch):
    """K5's plain version with both saves: out, x1, the saved qkv and the
    saved m (``m.astype(dt)``) against JAX's forward kernel."""
    x, _, layer = case
    tdt = getattr(torch, dtype)
    ref = jax_forward(x, layer, getattr(jnp, dtype), monkeypatch)
    got = fbt.train_forward(torch.from_numpy(x).to(tdt), torch.from_numpy(KEEP),
                            port_weights(layer, tdt), HEADS, EPS, save_qkv=True, save_m=True)
    assert got[2].shape == (B, CFG.num_tokens, 192) and got[3].shape == (B, CFG.num_tokens, 256)
    for name, g, r in zip(("out", "x1", "qkv", "m"), got, ref):
        assert g.dtype == tdt and g.shape == r.shape, name
        assert rel(g.float().numpy(), r) <= TOL[dtype][0], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_m_mlp_backward_matches_jax(case, dtype, monkeypatch):
    """K6a ``_ms`` (plain) against ``_mlp_backward_padded(..., m_sav=...)``,
    both fed JAX's forward's x1 and saved m: dx1 and the six grads."""
    x, _, layer = case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, x1, _, m = jax_forward(x, layer, jdt, monkeypatch)
    dout = cotangent(x1.shape)
    ref = _mlp_backward_padded(jnp.asarray(x1, jdt), jnp.asarray(dout, jdt),
                               jnp.asarray(KEEP)[:, None], jax_layer(layer, jdt), CFG, B,
                               interpret=True, m_sav=jnp.asarray(m, jdt))
    ref = port_layout(ref)
    dx1, grads = fbt.mlp_backward(torch.from_numpy(x1).to(tdt), torch.from_numpy(dout).to(tdt),
                                  torch.from_numpy(KEEP), port_weights(layer, tdt), EPS,
                                  m=torch.from_numpy(m).to(tdt))
    tol, wtol = TOL[dtype]
    for i, (g, r) in enumerate(zip((dx1, *grads), ref)):
        assert rel(g.float().numpy(), r.reshape(g.shape)) <= (tol if i == 0 else wtol), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_qkv_attn_backward_matches_jax(case, dtype, monkeypatch):
    """K7 ``_saved`` (plain) against ``_attn_backward_padded(..., qkv=...)``,
    both fed JAX's forward's saved qkv: dx and the six grads."""
    x, dx1, layer = case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    qkv = jax_forward(x, layer, jdt, monkeypatch)[2]
    ref = _attn_backward_padded(jnp.asarray(x, jdt), jnp.asarray(dx1, jdt),
                                jnp.asarray(KEEP)[:, None], jax_layer(layer, jdt), CFG, B,
                                interpret=True, qkv=jnp.asarray(qkv, jdt))
    ref = port_layout(ref)
    dx, grads = fbt.attn_backward(torch.from_numpy(x).to(tdt), torch.from_numpy(dx1).to(tdt),
                                  torch.from_numpy(KEEP), port_weights(layer, tdt), HEADS, EPS,
                                  qkv=torch.from_numpy(qkv).to(tdt))
    tol, wtol = TOL[dtype]
    for i, (g, r) in enumerate(zip((dx, *grads), ref)):
        assert rel(g.float().numpy(), r.reshape(g.shape)) <= (tol if i == 0 else wtol), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_mode,mlp_mode", [("saved", "saved"), ("recompute", "recompute"),
                                                ("saved", "recompute")])
def test_block_vjp_under_each_flavor_matches_jax(case, attn_mode, mlp_mode, dtype, monkeypatch):
    """:class:`FusedBlockTrain` forward and VJP under the switch pairs of
    tests/test_fused_block_train.py against JAX's custom VJP (Pallas
    interpret) under the same switches; the dropped crop's input grad is
    its output grad, bit for bit."""
    monkeypatch.setenv("EVT_TRAIN_ATTN", attn_mode)
    monkeypatch.setenv("EVT_TRAIN_MLP", mlp_mode)
    x, _, layer = case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fused = make_fused_block_train(CFG, interpret=True)
    keep = jnp.asarray(KEEP)
    out_j, gx_j, gw_j = jax_vjp(lambda xx, pp: fused(xx, pp, keep), x, layer, jdt)
    out_p, gx_p, gw_p = port_vjp(
        lambda xx, w: fbt.fused_block_train(xx, torch.from_numpy(KEEP), w, HEADS, EPS),
        torch.from_numpy(x).to(tdt), port_weights(layer, tdt))
    tol, wtol = TOL[dtype]
    assert rel(out_p, out_j) <= tol and rel(gx_p, gx_j) <= tol
    np.testing.assert_array_equal(gx_p[1], gx_j[1])
    for (k, _, _), gp, gj in zip(LAYOUT, gw_p, gw_j):
        assert rel(gp, gj) <= wtol, k


def test_saved_flavors_compute_the_recompute_function_at_float32(case):
    """At float32 nothing is rounded before it is saved: plain K7 ``_saved``
    agrees with plain K7, and plain K6a ``_ms`` with plain K6a, within 1e-6
    of each tensor's largest value."""
    x, dx1, layer = case
    w = port_weights(layer, torch.float32)
    xt, keep = torch.from_numpy(x), torch.from_numpy(KEEP)
    _, x1, qkv, m = fbt.train_forward_plain(xt, keep, w, HEADS, EPS, save_qkv=True, save_m=True)
    dout = torch.from_numpy(cotangent(x.shape))
    pairs = [(fbt.attn_backward_plain(xt, torch.from_numpy(dx1), keep, w, HEADS, EPS, qkv),
              fbt.attn_backward_plain(xt, torch.from_numpy(dx1), keep, w, HEADS, EPS)),
             (fbt.mlp_backward_plain(x1, dout, keep, w, EPS, m),
              fbt.mlp_backward_plain(x1, dout, keep, w, EPS))]
    for saved, recompute in pairs:
        for g, r in zip((saved[0], *saved[1]), (recompute[0], *recompute[1])):
            assert rel(g.numpy(), r.numpy()) <= 1e-6


def test_flavor_policy_follows_jax(monkeypatch):
    """``saved_flags`` and the narrow/wide rule read as JAX's: saved m only
    where a kernel reads it, the chunk count of ``_mlp_backward_padded``."""
    import easy_vitpose_tpu.models.fused_block_train as jfbt

    cases = [{}, {"EVT_TRAIN_ATTN": "saved"}, {"EVT_TRAIN_ATTN": "recompute", "EVT_TRAIN_MLP": "saved"},
             {"EVT_TRAIN_MLP": "saved", "EVT_TRAIN_WIDE": "recompute"}, {"EVT_TRAIN_ATTN": ""},
             {"EVT_TRAIN_WIDE": "saved", "EVT_TRAIN_MLP": "saved"}]
    for env in cases:
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for D in (64, 768, 1024, 1280):
            assert fbt.saved_flags(D) == jfbt.saved_flags(D), (env, D)
        assert fbt._wide_saved() == jfbt._wide_saved(), env
    for D, hidden, nj in ((768, 3072, 1), (1024, 4096, 2), (1280, 5120, 4), (1280, 5122, 1),
                          (1024, 4097, 1)):
        assert fbt.mlp_chunks(D, hidden) == nj


def test_a_bad_attention_flavor_raises(case, monkeypatch):
    """An ``EVT_TRAIN_ATTN`` other than saved or recompute raises, in the
    policy and in the block's forward, as JAX's does."""
    monkeypatch.setenv("EVT_TRAIN_ATTN", "on")
    with pytest.raises(ValueError, match="EVT_TRAIN_ATTN='on'"):
        fbt.saved_flags(64)
    x, _, layer = case
    with pytest.raises(ValueError, match="expected 'saved' or 'recompute'"):
        fbt.fused_block_train(torch.from_numpy(x), torch.from_numpy(KEEP),
                              port_weights(layer, torch.float32), HEADS, EPS)
