"""PyTorch port: the fused clip + Adam optimizer against the JAX package's.

JAX runs K8 (``_adam_leaf_pallas``) in interpret mode, as its own tests do
(``EVT_FUSED_OPT=pallas``, ``EVT_FUSED_OPT_INTERPRET=1``), and its default
``xla`` flavor.  The (1024, 1024) leaf is the one the Pallas kernel takes
(>= 1M elements, rows % 8, cols % 128); the others go through its XLA
fallback.  On the CPU the port's optimizer runs K8's plain version.  Given
equal gradients, and over the clip norm gradients whose norm both compute
exactly, the port and the ``xla`` flavor agree bit for bit over three steps: the same float32 operations in the same order,
each rounded.  The interpret-mode Pallas body is compiled as one fused XLA
computation, which contracts its multiply-adds into FMAs: it differs from
JAX's own ``xla`` flavor by one ulp in ~28% of the moments, and from the port
by as much.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.train import step as jstep
from easy_vitpose_tpu.train.fused_opt import make_fused_adam as jax_fused_adam
from easy_vitpose_tpu_torch.train import step as pstep
from easy_vitpose_tpu_torch.train.fused_opt import (adam_leaf, adam_leaf_plain, global_norm,
                                                    make_fused_adam)

SHAPES = {"big": (1024, 1024), "bias": (768,), "odd": (3, 5)}


def leaves(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def exact_norm_leaves(rng, c):
    """Leaves of +-c and +-2c, c a power of two, whose float32 global norm is
    exact in any summation order: every partial sum of squares is a whole
    multiple of c^2 under 2^24 c^2, and the total is a square, (s c)^2."""
    sizes = [int(np.prod(s)) for s in SHAPES.values()]
    n = sum(sizes)
    s = int(np.ceil(np.sqrt(n)))
    while (s * s - n) % 3:
        s += 1
    flat = np.full(n, c, np.float32)
    flat[rng.choice(n, (s * s - n) // 3, replace=False)] = 2 * c
    flat *= rng.choice(np.float32([-1, 1]), n)
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    return {k: v.reshape(shape) for (k, shape), v in zip(SHAPES.items(), parts)}


def run(flavor, monkeypatch, make_grads, lr=1e-3, steps=3):
    """(JAX params, mu, nu per step) and the port's, from the same grads
    ``make_grads(rng, step)``."""
    if flavor == "pallas":
        monkeypatch.setenv("EVT_FUSED_OPT", "pallas")
        monkeypatch.setenv("EVT_FUSED_OPT_INTERPRET", "1")
    else:
        monkeypatch.setenv("EVT_FUSED_OPT", "xla")
    rng = np.random.default_rng(0)
    p0 = leaves(rng, 0.5)
    grads = [make_grads(rng, i) for i in range(steps)]
    jtx, ptx = jax_fused_adam(lr, max_grad_norm=1.0), make_fused_adam(lr, max_grad_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    out = []
    for g in grads:
        jp, js, jg = jtx.fused_apply({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        pp, ps, pg = ptx.fused_apply({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        out.append(((jp, js, jg), (pp, ps, pg)))
    return out


def assert_equal(out, flavor):
    """Bit-equal against ``xla``; against ``pallas`` within two ulps of each
    leaf's largest value over three steps (measured 1.5; an FMA moves a
    value that nearly cancels by many of its own ulps)."""
    for (jp, js, jg), (pp, ps, pg) in out:
        for k in SHAPES:
            for j, p in ((jp, pp), (js.mu, ps.mu), (js.nu, ps.nu)):
                got, ref = p[k].numpy(), np.asarray(j[k])
                if flavor == "xla":
                    np.testing.assert_array_equal(got, ref, err_msg=k)
                else:
                    assert np.abs(got - ref).max() <= 2 * np.spacing(np.abs(ref).max()), k
        assert int(ps.count) == int(js.count)
        assert float(ps.hyperparams["learning_rate"]) == float(js.hyperparams["learning_rate"])


@pytest.mark.parametrize("flavor", ["pallas", "xla"])
def test_equal_unclipped(flavor, monkeypatch):
    """Gradients under the clip norm (s = 1), and the global norm (sums in
    another order) to 1e-6."""
    out = run(flavor, monkeypatch, lambda rng, _: leaves(rng, 1e-4))
    assert_equal(out, flavor)
    for (_, _, jg), (_, _, pg) in out:
        assert float(jg) < 1.0 and abs(float(pg) - float(jg)) <= 1e-6 * float(jg)


@pytest.mark.parametrize("flavor", ["pallas", "xla"])
def test_equal_clipped(flavor, monkeypatch):
    """Gradients over the clip norm (norms 1025 c: about 16, 32 and 8) that
    both compute exactly, so the clip scale is the same float32 division."""
    cs = (2.0 ** -6, 2.0 ** -5, 2.0 ** -7)
    out = run(flavor, monkeypatch, lambda rng, i: exact_norm_leaves(rng, cs[i]))
    assert_equal(out, flavor)
    for (_, _, jg), (_, _, pg) in out:
        assert float(pg) == float(jg) > 1.0


def test_learning_rate_controls(monkeypatch):
    """The plateau controller's set/get act on the optimizer state in both:
    a rate set between steps is the next update's (bit-equal params)."""
    monkeypatch.setenv("EVT_FUSED_OPT", "xla")
    rng = np.random.default_rng(1)
    p0, g = leaves(rng, 0.5), leaves(rng, 1e-4)
    jtx, ptx = jax_fused_adam(1e-3), make_fused_adam(1e-3)
    jp, pp = ({k: jnp.asarray(v) for k, v in p0.items()},
              {k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    js, ps = jtx.init(jp), ptx.init(pp)
    for lr in (1e-3, 5e-4):
        js, ps = jstep.set_learning_rate(js, lr), pstep.set_learning_rate(ps, lr)
        jp, js, _ = jtx.fused_apply({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        pp, ps, _ = ptx.fused_apply({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
    assert pstep.get_learning_rate(ps) == jstep.get_learning_rate(js) == np.float32(5e-4)
    for k in SHAPES:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))


def test_moments_other_than_f32_are_not_ported_and_leaves_check():
    """bf16 and int8 moments are ported now (tests/test_torch_fused_opt_q8.py
    holds them to JAX): both build and step; any other dtype raises."""
    params = {"a": torch.ones(5)}
    for md in ("bf16", "int8"):
        tx = make_fused_adam(1e-3, moment_dtype=md)
        new, state, _ = tx.fused_apply({"a": torch.full((5,), 0.1)}, tx.init(params), params)
        assert int(state.count) == 1 and torch.all(new["a"] < 1)
    with pytest.raises(ValueError):
        make_fused_adam(1e-3, moment_dtype="fp8")
    t = torch.ones(4)
    scal = torch.tensor([1.0, 1e-3, 0.1, 1e-3])
    assert all(torch.equal(a, b) for a, b in zip(adam_leaf(t, t, t, t, scal),
                                                 adam_leaf_plain(t, t, t, t, scal)))
    assert float(global_norm({"a": torch.full((4,), 3.0), "b": torch.full((16,), 2.0)})) == 10.0
