"""PyTorch port: the optimizer's table of leaves (``train/fused_opt.py``).

On the card a step is two launches over one table of every leaf: the norm
kernel, then K8 or K9 (``csrc/leaf_table.cuh``).  Here, on the CPU: the
plan covers every element of every leaf, and every codec block, exactly
once; the flat outputs give each leaf its own 16-byte-aligned span; the
leaf lookup (the kernels' binary search, as a plain function) finds each
unit's leaf; the table has the layout the kernels read; and the plain
table walks, which run the per-leaf plain versions on each work unit, equal
them bit for bit on ragged leaves from a numpy seed.  The clip scale's
plain version is held to JAX's ``fused_apply`` norm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.train import fused_opt as jfo
from easy_vitpose_tpu_torch.train import fused_opt as pfo

# ragged leaf sets: lengths around the 2048-element unit, empty and scalar
# leaves, 2-D leaves, and many one-unit leaves in a row
LEAF_SETS = {
    "ragged": [(1,), (3,), (1001,), (2047,), (2048,), (2049,)],
    "shapes": [(), (0,), (7, 300), (5000,), (3, 5), (0, 4), (64, 33)],
    "many": [(int(n),) for n in np.random.default_rng(5).integers(0, 2100, 300)],
}


def plan_of(shapes):
    return pfo.plan_leaves(tuple(torch.Size(s) for s in shapes))


@pytest.mark.parametrize("name", list(LEAF_SETS))
def test_units_cover_every_element_and_block_once(name):
    """Through the kernels' lookup, every element of every leaf falls in
    exactly one work unit, and each unit is one whole codec block of its
    leaf (block u - first[leaf], each block once)."""
    plan = plan_of(LEAF_SETS[name])
    hits = [np.zeros(int(n), np.int32) for n in plan.numels]
    blocks = [np.zeros(b, np.int32) for b in plan.blocks]
    for u, i, lo, hi in pfo.unit_spans(plan):
        assert lo % pfo.UNIT == 0 and 0 < hi - lo <= pfo.UNIT
        hits[i][lo:hi] += 1
        blocks[i][u - plan.first[i]] += 1
    assert all((h == 1).all() for h in hits)
    assert all((b == 1).all() for b in blocks)
    assert plan.units == sum(pfo.q8_blocks(int(n)) for n in plan.numels)


@pytest.mark.parametrize("name", list(LEAF_SETS))
def test_flat_outputs_are_aligned_and_disjoint(name):
    plan = plan_of(LEAF_SETS[name])
    offs, n = np.asarray(plan.offsets), plan.numels
    assert (offs % 4 == 0).all()
    assert (offs[1:] >= offs[:-1] + n[:-1]).all() and offs[-1] + n[-1] <= plan.total
    flat = torch.arange(plan.total, dtype=torch.float32)
    for v, s, o in zip(pfo._flat_views(flat, plan), plan.shapes, offs):
        assert v.shape == s and v.is_contiguous()
        assert torch.equal(v.reshape(-1), flat[o:o + v.numel()])


def test_leaf_of_unit_matches_searchsorted():
    """The binary search against numpy's on random leaf sets with runs of
    empty leaves, up to 3000 leaves."""
    rng = np.random.default_rng(0)
    for leaves in (1, 2, 7, 300, 3000):
        units = rng.integers(0, 4, leaves) * rng.integers(0, 2, leaves)
        units[rng.integers(leaves)] += 1
        first = np.concatenate([[0], np.cumsum(units)])
        for u in range(int(first[-1])):
            want = int(np.searchsorted(first[:leaves], u, side="right")) - 1
            assert pfo.leaf_of_unit(first, leaves, u) == want, (leaves, u)
            assert units[want] > 0


def test_table_layout():
    """The int64 table of csrc/leaf_table.cuh: a zero ticket, the first-unit
    column with the total, then per leaf its count and the columns."""
    plan = plan_of([(5,), (4096,), (0,), (3, 1000)])
    cols = [np.arange(4) * 16 + 1000, np.arange(4) * 16 + 2000]
    t = pfo._table(plan, cols)
    L = 4
    assert t.dtype == np.int64 and t.shape == (2 + L + 3 * L,) and t[0] == 0
    np.testing.assert_array_equal(t[1:2 + L], [0, 1, 3, 3, 5])
    rows = t[2 + L:].reshape(L, 3)
    np.testing.assert_array_equal(rows[:, 0], [5, 4096, 0, 3000])
    np.testing.assert_array_equal(rows[:, 1], cols[0])
    np.testing.assert_array_equal(rows[:, 2], cols[1])


@pytest.mark.parametrize("kind,dtype", [("f32", torch.float32), ("codes", torch.int8),
                                        ("scales", torch.float32)])
def test_flat_leaves_views_and_addresses(kind, dtype):
    """A step's flat output by name: each view made on access equals the
    eager views of the list API, and the next step's table takes the
    buffer's address plus the plan's offsets, the views' own addresses."""
    names = [f"l{i}" for i in range(len(LEAF_SETS["shapes"]))]
    plan = plan_of(LEAF_SETS["shapes"])
    flat = pfo._new_flat(plan, kind, dtype, "cpu")
    flat.copy_(torch.arange(flat.numel()).reshape(flat.shape).to(dtype))
    lazy = pfo.FlatLeaves(names, flat, plan, kind)
    eager = pfo._views(flat, plan, kind)
    assert list(lazy) == names and len(lazy) == len(names)
    for k, v in zip(reversed(names), reversed(eager)):
        assert lazy[k].shape == v.shape and torch.equal(lazy[k], v) and lazy[k] is lazy[k]
    keep = []
    addrs = pfo._column(lazy, list(names), plan, kind, dtype, flat.device, keep)
    per_leaf = pfo._column(dict(lazy), names, plan, kind, dtype, flat.device, [])
    assert keep == [flat]
    assert [int(a) for a, v in zip(addrs, eager) if v.numel()] == \
        [a for a, v in zip(per_leaf, eager) if v.numel()]
    with pytest.raises(ValueError):
        pfo._column(dict(lazy), names, plan_of(LEAF_SETS["ragged"]), kind, dtype, flat.device, [])


def test_moment_bytes_of_flat_leaves():
    """``moment_bytes`` counts each leaf's view of a flat output."""
    plan = plan_of([(3000,), (7, 5)])
    names = ["a", "b"]
    tree = {"q_tree": pfo.FlatLeaves(names, pfo._new_flat(plan, "codes", torch.int8, "cpu"),
                                     plan, "codes"),
            "s_tree": pfo.FlatLeaves(names, pfo._new_flat(plan, "scales", torch.float32, "cpu"),
                                     plan, "scales")}
    state = pfo.FusedAdamState(torch.zeros((), dtype=torch.int32), tree, tree, {})
    assert pfo.moment_bytes(state) == 2 * (4096 + 2048 + 4 * 3)


def leaves(rng, shapes, scale):
    return [torch.from_numpy(np.asarray(rng.standard_normal(s) * scale, np.float32))
            for s in shapes]


@pytest.mark.parametrize("name", list(LEAF_SETS))
def test_adam_table_plain_equals_per_leaf(name):
    """K8's table walk: every leaf's (mu', nu', p') bit-equal to
    ``adam_leaf_plain`` on the whole leaf, and a view of its flat output."""
    shapes = LEAF_SETS[name]
    rng = np.random.default_rng(1)
    g, mu, p = leaves(rng, shapes, 1e-3), leaves(rng, shapes, 1e-3), leaves(rng, shapes, 1.0)
    nu = [t.square() for t in leaves(rng, shapes, 1e-3)]
    scal = torch.tensor([0.37, 3.75e-4, 1 - 0.9 ** 7, 1 - 0.999 ** 7])
    out = pfo.adam_table(g, mu, nu, p, scal)
    for i, s in enumerate(shapes):
        for got, ref in zip((o[i] for o in out), pfo.adam_leaf_plain(g[i], mu[i], nu[i], p[i],
                                                                     scal)):
            assert got.shape == torch.Size(s) and torch.equal(got, ref), (name, i)


@pytest.mark.parametrize("name", list(LEAF_SETS))
def test_adam_table_q8_plain_equals_per_leaf(name):
    """K9's table walk, one codec block per unit: codes, scales and p' of
    every leaf bit-equal to ``adam_leaf_q8_plain`` on the whole leaf."""
    shapes = LEAF_SETS[name]
    rng = np.random.default_rng(2)
    g, p = leaves(rng, shapes, 1e-3), leaves(rng, shapes, 1.0)
    state = [(*pfo.q8_encode(m, 127), *pfo.q8_encode(v.abs(), 255))
             for m, v in zip(leaves(rng, shapes, 1e-3), leaves(rng, shapes, 1e-3))]
    mq, ms, nq, ns = (list(x) for x in zip(*state))
    scal = torch.tensor([0.7, 3.75e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3])
    out = pfo.adam_table_q8(g, mq, ms, nq, ns, p, scal)
    for i in range(len(shapes)):
        got = [o[i] for o in out]
        if g[i].numel() == 0:
            assert [t.numel() for t in got] == [0] * 5
            continue
        ref = pfo.adam_leaf_q8_plain(g[i], mq[i], ms[i], nq[i], ns[i], p[i], scal)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), (name, i)


def test_per_leaf_wrappers_are_one_leaf_tables():
    """``adam_leaf`` and ``adam_leaf_q8`` on CPU tensors equal the table
    walk over that one leaf."""
    rng = np.random.default_rng(3)
    g, mu, p = leaves(rng, [(2049,)] * 3, 1e-3)
    nu = mu.square()
    scal = torch.tensor([1.0, 1e-3, 0.19, 1 - 0.999 ** 2])
    for a, b in zip(pfo.adam_leaf(g, mu, nu, p, scal), pfo.adam_table([g], [mu], [nu], [p], scal)):
        assert torch.equal(a, b[0])
    mq, ms = pfo.q8_encode(mu, 127)
    nq, ns = pfo.q8_encode(nu.sqrt(), 255)
    for a, b in zip(pfo.adam_leaf_q8(g, mq, ms, nq, ns, p, scal),
                    pfo.adam_table_q8([g], [mq], [ms], [nq], [ns], [p], scal)):
        assert torch.equal(a, b[0])


def exact_norm_leaves(rng, shapes, c):
    """Leaves of +-c and +-2c (c a power of two) whose sum of squares is
    exact in any order and a square, so the norm is exact."""
    sizes = [int(np.prod(s)) for s in shapes]
    n = sum(sizes)
    s = int(np.ceil(np.sqrt(n)))
    while (s * s - n) % 3:
        s += 1
    flat = np.full(n, c, np.float32)
    flat[rng.choice(n, (s * s - n) // 3, replace=False)] = 2 * c
    flat *= rng.choice(np.float32([-1, 1]), n)
    return [torch.from_numpy(v.reshape(sh)) for v, sh in
            zip(np.split(flat, np.cumsum(sizes)[:-1]), shapes)], s * c


@pytest.mark.parametrize("c,max_norm", [(2.0 ** -6, 1.0), (2.0 ** -12, 1.0), (2.0 ** -6, 1e3)])
def test_clip_scale_plain_matches_jax(c, max_norm):
    """(s, ||g||) against JAX's ``fused_apply`` (its norm and its clip scale
    expression) on exact-norm leaves, bit for bit, clipped and not."""
    rng = np.random.default_rng(4)
    shapes = LEAF_SETS["ragged"] + [(64, 33)]
    gs, norm = exact_norm_leaves(rng, shapes, c)
    sg = pfo.clip_scale(gs, max_norm)
    assert float(sg[1]) == norm
    tx = jfo.make_fused_adam(1e-3, max_grad_norm=max_norm)
    params = {str(i): jnp.zeros(s, jnp.float32) for i, s in enumerate(shapes)}
    _, _, jnorm = tx.fused_apply({str(i): jnp.asarray(g.numpy()) for i, g in enumerate(gs)},
                                 tx.init(params), params)
    js = jnp.minimum(1.0, max_norm / (jnorm + 1e-16))
    assert float(sg[1]) == float(jnorm) and float(sg[0]) == float(js)
    assert sg.dtype == torch.float32 and (float(sg[0]) < 1.0) == (norm > max_norm)


def test_fused_apply_writes_none_of_its_inputs():
    """The CPU step, f32 and int8: grads, state and params unchanged."""
    rng = np.random.default_rng(6)
    shapes = {"w": (7, 300), "b": (2049,), "s": (3,)}
    params = dict(zip(shapes, leaves(rng, list(shapes.values()), 0.5)))
    grads = dict(zip(shapes, leaves(rng, list(shapes.values()), 1e-2)))
    for md in ("f32", "int8"):
        tx = pfo.make_fused_adam(1e-3, moment_dtype=md)
        state = tx.init(params)
        params, state, _ = tx.fused_apply(grads, state, params)    # non-zero moments
        before = [t.clone() for t in _tensors((grads, params, state))]
        tx.fused_apply(grads, state, params)
        assert all(torch.equal(a, b) for a, b in zip(before, _tensors((grads, params, state))))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)
