"""PyTorch port: the wide MLP backward's opt-in flavors against the JAX
package's Pallas kernels in interpret mode.

At ViT-L's width, as tests/test_torch_train_block_wide.py (D=1024, hidden
4096, two crops, one kept at 2 and one dropped):

* ``EVT_TRAIN_MLP=saved``: K6b ``_ms`` then K6c against
  ``_bwd_mlp_dx_save_kernel_ms`` + ``_bwd_mlp_dw_saved_kernel``, both fed
  one saved m (the fc1 output of the same x1, rounded to the working
  dtype, made here with jnp);
* ``EVT_TRAIN_WIDE=recompute``: K6d then K6e against
  ``_bwd_mlp_dx_kernel`` + ``_bwd_mlp_dw_kernel`` (hidden dim in two chunks).

The port's plain versions (what the wrappers run on the CPU) are held to
the seven outputs of ``_mlp_backward_padded`` at 1e-5 (float32) and 1e-2
(bf16) of each output's largest value; and the plain K6d then K6e to the
plain K6b then K6c exactly: the same function, the chain shared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.models.fused_block_train import _mlp_backward_padded
from easy_vitpose_tpu_torch.models import fused_block_train as fbt
from tests.test_torch_train_block import port_weights, rel
from tests.test_torch_train_block_wide import B, CFG, HIDDEN, KEEP, OUTPUTS, case  # noqa: F401

torch.set_num_threads(2)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def saved_m(x1, layer, jdt):
    """(B, N, hidden) m = LN2(x1) fc1 + b in float32, rounded to ``jdt``, as
    the forward kernel saves it."""
    x = jnp.asarray(x1, jdt).astype(jnp.float32)
    mean = x.mean(-1, keepdims=True)
    xhat = (x - mean) * jnp.reciprocal(jnp.sqrt(((x - mean) ** 2).mean(-1, keepdims=True)
                                                + CFG.layer_norm_eps))
    h2 = (xhat * jnp.asarray(layer["ln2_s"], jdt).astype(jnp.float32)
          + jnp.asarray(layer["ln2_b"], jdt).astype(jnp.float32)).astype(jdt)
    m = jnp.dot(h2, jnp.asarray(layer["mlp"]["fc1_w"], jdt), preferred_element_type=jnp.float32)
    return (m + jnp.asarray(layer["mlp"]["fc1_b"], jdt).astype(jnp.float32)).astype(jdt)


def jax_outputs(x1, dout, layer, jdt, m_sav=None):
    out = _mlp_backward_padded(jnp.asarray(x1, jdt), jnp.asarray(dout, jdt),
                               jnp.asarray(KEEP)[:, None],
                               {k: (jnp.asarray(v, jdt) if k != "mlp" else
                                    {kk: jnp.asarray(vv, jdt) for kk, vv in v.items()})
                                for k, v in layer.items()},
                               CFG, B, interpret=True, m_sav=m_sav)
    out = [np.asarray(o, np.float32) for o in out]
    return dict(zip(OUTPUTS, (out[0], out[1].T, out[2][0], out[3].T, out[4][0], out[5][0],
                              out[6][0])))


def check(got, ref, dtype):
    for k in OUTPUTS:
        g = got[k].float().numpy()
        assert g.shape == ref[k].shape, k
        assert rel(g, ref[k]) <= TOL[dtype], (k, rel(g, ref[k]))
    np.testing.assert_array_equal(got["dx1"][1].float().numpy(), ref["dx1"][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_m_wide_mlp_backward_matches_jax(case, dtype, monkeypatch):  # noqa: F811
    """K6b ``_ms`` then K6c (plain) against JAX's saved-m wide kernels; the
    dropped crop's dx1 is its dout, bit for bit."""
    monkeypatch.delenv("EVT_TRAIN_WIDE", raising=False)
    monkeypatch.setenv("EVT_TRAIN_MLP", "saved")
    x1, dout, layer = case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    m = saved_m(x1, layer, jdt)
    ref = jax_outputs(x1, dout, layer, jdt, m_sav=m)
    w = port_weights(layer, tdt)
    mt = torch.from_numpy(np.array(m, np.float32)).to(tdt)
    dx1, grads = fbt.block_mlp_backward(torch.from_numpy(x1).to(tdt),
                                        torch.from_numpy(dout).to(tdt), torch.from_numpy(KEEP),
                                        w, CFG.layer_norm_eps, m=mt)
    check(dict(zip(OUTPUTS, (dx1, *grads))), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_recompute_flavor_matches_jax(case, dtype, monkeypatch):  # noqa: F811
    """K6d then K6e (plain) against JAX's recompute wide kernels under
    ``EVT_TRAIN_WIDE=recompute``."""
    monkeypatch.setenv("EVT_TRAIN_WIDE", "recompute")
    x1, dout, layer = case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_outputs(x1, dout, layer, jdt)
    w = port_weights(layer, tdt)
    args = (torch.from_numpy(x1).to(tdt), torch.from_numpy(dout).to(tdt),
            torch.from_numpy(KEEP), w, CFG.layer_norm_eps)
    dx1, db2, dln_w, dln_b = fbt.mlp_backward_dx(*args)
    dW1, db1, dW2 = fbt.mlp_backward_dw(*args)
    assert dW1.shape == (HIDDEN, x1.shape[-1]) and db1.shape == (HIDDEN,)
    check(dict(zip(OUTPUTS, (dx1, dW1, db1, dW2, db2, dln_w, dln_b))), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_recompute_equals_saved_operands_exactly(case, dtype):  # noqa: F811
    """Plain K6d then K6e is plain K6b then K6c, bit for bit, and the
    policy's dispatcher picks them by ``wide_saved``."""
    x1, dout, layer = case
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x1).to(tdt), torch.from_numpy(dout).to(tdt),
            torch.from_numpy(KEEP), port_weights(layer, tdt), CFG.layer_norm_eps)
    saved = fbt.block_mlp_backward(*args, wide_saved=True)
    recompute = fbt.block_mlp_backward(*args, wide_saved=False)
    for a, b in zip((saved[0], *saved[1]), (recompute[0], *recompute[1])):
        assert a.dtype == b.dtype == tdt and torch.equal(a, b)
    with pytest.raises(ValueError, match="no saved m"):
        fbt.block_mlp_backward(*args, m=torch.zeros(B, x1.shape[1], HIDDEN, dtype=tdt),
                               wide_saved=False)
