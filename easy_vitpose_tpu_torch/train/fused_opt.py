"""Fused clip + Adam: one launch over every parameter leaf of a step (K8, K9).

Port of ``easy_vitpose_tpu/train/fused_opt.py``:
``make_fused_adam(lr, max_grad_norm, moment_dtype).init(params)``
and ``.fused_apply(grads, state, params)`` over dicts of float32 tensors
keyed by state-dict name.  The update rule is optax's clip_by_global_norm ->
adam (eps_root 0), with optax's defaults b1 0.9, b2 0.999, eps 1e-8 as
constants (the reference's callers pass no others):

  s   = min(1, max_norm / (||g|| + 1e-16))
  mu' = b1*mu + (1-b1)*(s*g)
  nu' = b2*nu + ((1-b2)*(s*g))*(s*g)
  p'  = p - (lr * (mu'/(1-b1^t))) / (sqrt(nu'/(1-b2^t)) + eps)

The moments are stored at ``moment_dtype``:

* ``"f32"``: K8 (``csrc/adam.cu``) replaces ``_adam_leaf_pallas``: it reads
  g, mu, nu and p once and writes mu', nu' and p' once, 28 bytes per
  element, which is what bounds it on the H100 (86M parameters of ViT-B:
  2.4 GB, 0.72 ms at 3.35 TB/s).
* ``"bf16"``: the moments are cast to bfloat16 between steps and the update
  runs in float32, in plain torch (JAX has no kernel for it either).
* ``"int8"``: blockwise geometric 8-bit moments (:func:`q8_encode`): per
  block of 2048 elements one float32 absmax scale and a log-spaced code,
  mu signed with 127 levels, sqrt(nu) unsigned with 255, bounding the
  decode error at ~5.6% and ~2.8% relative.  K9 (``csrc/adam_q8.cu``)
  replaces ``_adam_leaf_pallas_q8``: decode, update, re-encode in one pass,
  16 bytes per element (ViT-L's 308M parameters: 4.9 GB, 1.47 ms).  The
  state is ``{"q_tree": {name: codes}, "s_tree": {name: scales}}`` for each
  moment, as JAX's.  The port codes its own leaves: each leaf flattened in
  torch's (out, in) layout and padded with zeros to whole blocks, where JAX
  codes its depth-stacked (in, out) leaves; the same moments are so grouped
  into other blocks with other scales (ROADMAP.md queue C 9).

On the card a step is two hand-written launches whatever the number of
leaves: the global norm and clip scale (``csrc/grad_norm.cu``), then K8 or
K9, both over one table of leaves (``csrc/leaf_table.cuh``, built by
:func:`plan_leaves` and ``_table``): per leaf its element count, its
pointers and its first work unit of 2048 elements (one codec block).  The
table is copied to the card once per step from pinned memory; the kernels
find a unit's leaf by the binary search of :func:`leaf_of_unit`.  Each
output kind is one flat buffer per step, with a view per leaf that starts
on 16 bytes.  The bias corrections and the learning rate stay a few torch
operations on the device, and the clip scale and norm reach the kernels in
a device buffer ``(s, lr, 1-b1^t, 1-b2^t)``, so a step never waits on the
host.  ``fused_apply`` writes none of its inputs.  The Pallas kernels'
gates (>= 1M elements, K8's %128 and %8, K9's nb % 32) are TPU tiling
rules: every leaf goes through the kernels.

The plain versions take CPU tensors: :func:`global_norm`,
:func:`adam_leaf_plain` (``_adam_leaf_xla``) and :func:`adam_leaf_q8_plain`
(the Pallas body, step by step) per leaf, and :func:`adam_table_plain`,
which walks the table's work units with them.  Each kernel agrees with its
plain version bit for bit: it rounds each operation where the plain version
does, with IEEE division and square root.  JAX's codec divides by its
constants, which XLA folds into a multiply by the float32 reciprocal; the
port multiplies by the same reciprocals.  The norm kernel sums in another
order than :func:`global_norm`: equal where the sums are exact, within
float32 rounding (rel 1e-5) otherwise.
"""
from __future__ import annotations

import functools
import operator
from typing import Callable, Dict, List, Mapping, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

KERNEL, KERNEL_Q8, KERNEL_NORM = "adam", "adam_q8", "grad_norm"
MOMENT_DTYPES = ("f32", "bf16", "int8")
B1, B2, EPS = 0.9, 0.999, 1e-8
Tensors = Dict[str, torch.Tensor]

# the int8 codec (``_q8_encode`` / ``_q8_decode``), every constant a float32
Q8_BLOCK = 2048
Q8_LN_EPS = float(np.float32(np.log(1e-6)))     # magnitudes under 1e-6 * absmax code to 0
Q8_INV_LN_EPS = float(np.float32(1) / np.float32(Q8_LN_EPS))
Q8_TINY, Q8_ZERO_BELOW = float(np.float32(1e-30)), float(np.float32(1e-6))


def q8_inv_steps(levels: int) -> float:
    """float32 1 / (levels - 1), XLA's reciprocal of the codec's divisor."""
    return float(np.float32(1) / np.float32(levels - 1))


class FusedAdamState(NamedTuple):
    count: torch.Tensor        # int32 step counter
    mu: dict                   # first moments: {name: tensor}, or int8 {"q_tree", "s_tree"}
    nu: dict                   # second moments, likewise (int8: sqrt(nu), unsigned codes)
    hyperparams: Dict[str, torch.Tensor]   # {"learning_rate": float32} of the last update


class FusedAdam(NamedTuple):
    init: Callable
    fused_apply: Callable


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: torch's vectorized CPU
    sqrt is not (it misses by one ulp in ~0.5% of values); the float64 root
    of a float32 value rounds to the IEEE float32 one."""
    return torch.sqrt(x.double()).float()


def adam_leaf_plain(g, mu, nu, p, scal):
    """Plain version of K8 (``_adam_leaf_xla``): -> (mu', nu', p')."""
    s, lr, c1, c2 = scal.unbind()
    gs = g.float() * s
    mu_n = B1 * mu + (1.0 - B1) * gs
    nu_n = B2 * nu + (1.0 - B2) * gs * gs
    p_n = p - lr * (mu_n / c1) / (sqrt_rn(nu_n / c2) + EPS)
    return mu_n, nu_n, p_n


def adam_leaf(g, mu, nu, p, scal):
    """K8 on one float32 leaf of any shape, a table of one leaf: CPU tensors
    take the plain version, CUDA tensors launch the kernel.  -> new (mu',
    nu', p')."""
    if p.device.type == "cpu":
        return adam_leaf_plain(g, mu, nu, p, scal)
    (mu_o,), (nu_o,), (p_o,) = adam_table([g], [mu], [nu], [p], scal)
    return mu_o, nu_o, p_o


# --------------------------------------------------------------- int8 codec
def q8_blocks(n: int) -> int:
    return -(-n // Q8_BLOCK)


def _pad_blocks(x: torch.Tensor, nb: int) -> torch.Tensor:
    """``x`` flattened to float32 and padded with zeros to (nb, 2048)."""
    return F.pad(x.float().reshape(-1), (0, nb * Q8_BLOCK - x.numel())).reshape(nb, Q8_BLOCK)


def _q8_levels(r: torch.Tensor, levels: int) -> torch.Tensor:
    """The code level (float32, 0..levels) of magnitudes ``r = |x| / absmax``."""
    t = torch.log(r.clamp_min(Q8_TINY)) * Q8_INV_LN_EPS
    idx = (1.0 + torch.round((1.0 - t) * float(levels - 1))).clamp(1.0, float(levels))
    return torch.where(r < Q8_ZERO_BELOW, 0.0, idx)


def _q8_values(mag: torch.Tensor, levels: int) -> torch.Tensor:
    """The magnitude (relative to absmax) of code level ``mag`` >= 1."""
    return torch.exp(Q8_LN_EPS * (1.0 - (mag - 1.0) * q8_inv_steps(levels)))


def q8_encode(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_q8_encode``: flatten, pad with zeros to whole blocks, code each
    magnitude on the geometric map -> (codes (nb*2048,), scales (nb, 1)
    float32).  ``levels`` 127: signed int8 codes; 255: unsigned uint8."""
    xf = _pad_blocks(x, q8_blocks(x.numel()))
    absx = xf.abs()
    scale = absx.amax(1, keepdim=True)
    idx = _q8_levels(absx / scale.clamp_min(Q8_TINY), levels)
    if levels == 127:
        return (torch.sign(xf) * idx).to(torch.int8).reshape(-1), scale
    return idx.to(torch.uint8).reshape(-1), scale


def q8_decode(codes: torch.Tensor, scale: torch.Tensor, levels: int, shape) -> torch.Tensor:
    """``_q8_decode``: the inverse of :func:`q8_encode` -> float32 of ``shape``."""
    cf = codes.float().reshape(-1, Q8_BLOCK)
    mag = cf.abs()
    x = torch.where(mag < 0.5, 0.0, torch.sign(cf) * _q8_values(mag, levels) * scale)
    return x.reshape(-1)[:int(np.prod(shape, dtype=np.int64))].reshape(shape)


def adam_leaf_q8_plain(g, mq, ms, nq, ns, p, scal):
    """Plain version of K9, the Pallas body of ``_adam_leaf_pallas_q8``
    operation by operation on any leaf length (g and p padded with zeros to
    whole blocks): decode, clip + Adam with mu' and nu' before they are
    coded, re-encode.  -> (mu codes, mu scales, nu codes, nu scales, p')."""
    s, lr, c1, c2 = scal.unbind()
    n = p.numel()
    nb = q8_blocks(n)
    mqf = mq.float().reshape(nb, Q8_BLOCK)
    mag = mqf.abs()
    mu = torch.where(mag < 0.5, 0.0, torch.sign(mqf) * _q8_values(mag, 127) * ms)
    nqf = nq.float().reshape(nb, Q8_BLOCK)   # JAX's int8 bitcast and +256 give these values
    vs = torch.where(nqf < 0.5, 0.0, _q8_values(nqf, 255) * ns)
    gs = _pad_blocks(g, nb) * s
    mu_n = B1 * mu + (1.0 - B1) * gs
    nu_n = B2 * (vs * vs) + (1.0 - B2) * gs * gs
    p_n = _pad_blocks(p, nb) - lr * (mu_n / c1) / (sqrt_rn(nu_n / c2) + EPS)
    am = mu_n.abs().amax(1, keepdim=True)
    idx = _q8_levels(mu_n.abs() / am.clamp_min(Q8_TINY), 127)
    mq_n = (torch.sign(mu_n) * idx).to(torch.int8).reshape(-1)
    vs_n = sqrt_rn(nu_n)
    an = vs_n.amax(1, keepdim=True)
    idxn = _q8_levels(vs_n / an.clamp_min(Q8_TINY), 255)
    wrapped = torch.where(idxn > 127.5, idxn - 256.0, idxn)          # the uint8 wrap
    nq_n = wrapped.to(torch.int8).view(torch.uint8).reshape(-1)
    return mq_n, am, nq_n, an, p_n.reshape(-1)[:n].reshape(p.shape)


def adam_leaf_q8(g, mq, ms, nq, ns, p, scal):
    """K9 on one float32 leaf of any shape, a table of one leaf: CPU tensors
    take the plain version, CUDA tensors launch the kernel.  -> (mu codes,
    mu scales, nu codes, nu scales, p')."""
    if p.device.type == "cpu":
        return adam_leaf_q8_plain(g, mq, ms, nq, ns, p, scal)
    return tuple(out[0] for out in adam_table_q8([g], [mq], [ms], [nq], [ns], [p], scal))


# ------------------------------------------------------- the table of leaves
UNIT = Q8_BLOCK          # a work unit of the table kernels: 2048 elements, one codec block
NORM_BLOCKS = 1024       # the norm kernel's grid at most (csrc/grad_norm.cu MAX_BLOCKS)
_ALIGN = 4               # float32 elements: each leaf of a flat output starts on 16 bytes
# the kinds of flat buffer: float32 leaves, codes (nb * 2048 a leaf), scales (nb, 1)
F32, CODES, SCALES = "f32", "codes", "scales"


class LeafPlan(NamedTuple):
    """Where each leaf of a step lies in the table and the flat outputs."""
    shapes: Tuple[torch.Size, ...]
    numels: np.ndarray           # int64 (L,)
    first: np.ndarray            # int64 (L + 1,): each leaf's first work unit, then the total
    sizes: Tuple[int, ...]       # elements of each leaf
    blocks: Tuple[int, ...]      # work units (codec blocks) of each leaf
    code_sizes: Tuple[int, ...]  # codes of each leaf, blocks * 2048
    offsets: Tuple[int, ...]     # each leaf's start in a flat float32 output, a multiple of 4
    strides: Tuple[Tuple[int, ...], ...]
    total: int                   # elements of a flat float32 output

    @property
    def units(self) -> int:
        return int(self.first[-1])


@functools.lru_cache(maxsize=32)
def plan_leaves(shapes: Tuple[torch.Size, ...]) -> LeafPlan:
    """The plan of leaves of these shapes (cached: a model's shapes stay)."""
    numels = np.array([int(np.prod(s, dtype=np.int64)) for s in shapes], np.int64)
    blocks = -(-numels // UNIT)
    first = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int64)
    padded = -(-numels // _ALIGN) * _ALIGN
    offsets = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    strides = tuple(tuple(int(np.prod(s[k + 1:], dtype=np.int64)) for k in range(len(s)))
                    for s in shapes)
    return LeafPlan(tuple(shapes), numels, first, tuple(numels.tolist()), tuple(blocks.tolist()),
                    tuple((blocks * Q8_BLOCK).tolist()), tuple(offsets.tolist()), strides,
                    int(padded.sum()))


def leaf_of_unit(first: Sequence[int], leaves: int, u: int) -> int:
    """The leaf of work unit ``u``: the largest i with ``first[i] <= u``
    (empty leaves are skipped).  The kernels' search
    (``csrc/leaf_table.cuh::find_leaf``), step for step."""
    lo, hi = 0, leaves - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= u:
            lo = mid
        else:
            hi = mid - 1
    return lo


def unit_spans(plan: LeafPlan):
    """(unit, leaf, lo, hi) of every work unit, the leaf found as the
    kernels find it: elements lo..hi of the leaf, its codec block
    ``unit - first[leaf]``."""
    first, L = plan.first.tolist(), len(plan.shapes)
    for u in range(plan.units):
        i = leaf_of_unit(first, L, u)
        lo = (u - first[i]) * UNIT
        yield u, i, lo, min(plan.sizes[i], lo + UNIT)


def _table(plan: LeafPlan, cols: Sequence) -> np.ndarray:
    """The int64 table of ``csrc/leaf_table.cuh``: the norm's ticket (0),
    the first-unit column, then per leaf its element count and ``cols``
    (one address per leaf each; column 1 is the gradient)."""
    L, width = len(plan.shapes), 1 + len(cols)
    t = np.zeros(2 + L + L * width, np.int64)
    t[1:2 + L] = plan.first
    rows = t[2 + L:].reshape(L, width)
    rows[:, 0] = plan.numels
    for j, c in enumerate(cols, 1):
        rows[:, j] = c
    return t


# ---- flat buffers: one per output kind and step, a view per leaf
def _new_flat(plan: LeafPlan, kind: str, dtype: torch.dtype, dev) -> torch.Tensor:
    size = {F32: plan.total, CODES: plan.units * Q8_BLOCK, SCALES: (plan.units, 1)}[kind]
    return torch.empty(size, dtype=dtype, device=dev)


def _byte_offsets(plan: LeafPlan, kind: str) -> np.ndarray:
    """Each leaf's start in a flat buffer of ``kind``, in bytes."""
    if kind == F32:
        return np.asarray(plan.offsets, np.int64) * 4
    return plan.first[:-1] * (Q8_BLOCK if kind == CODES else 4)


def _flat_views(flat: torch.Tensor, plan: LeafPlan) -> List[torch.Tensor]:
    return [flat.as_strided(s, st, o) for s, st, o in zip(plan.shapes, plan.strides, plan.offsets)]


def _views(flat: torch.Tensor, plan: LeafPlan, kind: str) -> List[torch.Tensor]:
    if kind == F32:
        return _flat_views(flat, plan)
    return list(torch.split(flat, plan.code_sizes if kind == CODES else plan.blocks))


class FlatLeaves(Mapping):
    """One output kind of a table launch by leaf name: the step's flat
    buffer, each leaf's view made on first access.  The next step's launch
    reads only the buffer's address and the plan, so a step makes no view
    of its moments unless someone asks for one."""

    def __init__(self, names: List[str], flat: torch.Tensor, plan: LeafPlan, kind: str):
        self.names, self.flat, self.plan, self.kind = names, flat, plan, kind
        self._views: Dict[str, torch.Tensor] = {}
        self._index = None

    def __getitem__(self, k: str) -> torch.Tensor:
        v = self._views.get(k)
        if v is None:
            if self._index is None:
                self._index = {n: i for i, n in enumerate(self.names)}
            i = self._index[k]
            if self.kind == F32:
                v = self.flat.as_strided(self.plan.shapes[i], self.plan.strides[i],
                                         self.plan.offsets[i])
            else:
                lo, hi = int(self.plan.first[i]), int(self.plan.first[i + 1])
                v = (self.flat[lo * Q8_BLOCK:hi * Q8_BLOCK] if self.kind == CODES else
                     self.flat[lo:hi])
            self._views[k] = v
        return v

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)


# ---- the table's columns, checked, and its copy to the card
_DEVICE, _DTYPE = operator.attrgetter("device"), operator.attrgetter("dtype")


def _checked(ts: List[torch.Tensor], dev, dtype: torch.dtype, sizes: Tuple[int, ...]):
    """``ts`` contiguous after checking each one's device, dtype and size."""
    if (len(ts) != len(sizes) or set(map(_DEVICE, ts)) - {dev} or set(map(_DTYPE, ts)) - {dtype}
            or tuple(map(torch.Tensor.numel, ts)) != sizes):
        for i, (t, n) in enumerate(zip(ts, sizes)):
            if t.device != dev or t.dtype != dtype or t.numel() != n:
                raise ValueError(f"leaf {i}: got {t.dtype} x {t.numel()} on {t.device}, "
                                 f"expected {dtype} x {n} on {dev}")
        raise ValueError(f"{len(ts)} leaves where {len(sizes)} were expected")
    return ts if all(map(torch.Tensor.is_contiguous, ts)) else [t.contiguous() for t in ts]


def _column(group, names, plan: LeafPlan, kind: str, dtype: torch.dtype, dev, keep: list):
    """The addresses of one input column: a :class:`FlatLeaves` of this
    plan gives its buffer's address and the plan's offsets; a list, or a
    mapping read in ``names``' order, is checked leaf by leaf (and kept in
    ``keep`` until the launches are enqueued, with any contiguous copies)."""
    if (isinstance(group, FlatLeaves) and group.plan is plan and group.kind == kind
            and group.names == names):
        if group.flat.device != dev or group.flat.dtype != dtype:
            raise ValueError(f"flat leaves of {group.flat.dtype} on {group.flat.device}, "
                             f"expected {dtype} on {dev}")
        keep.append(group.flat)
        return group.flat.data_ptr() + _byte_offsets(plan, kind)
    ts = [group[k] for k in names] if isinstance(group, Mapping) else list(group)
    ts = _checked(ts, dev, dtype, {F32: plan.sizes, CODES: plan.code_sizes,
                                   SCALES: plan.blocks}[kind])
    keep.append(ts)
    return list(map(torch.Tensor.data_ptr, ts))


class _Table(NamedTuple):
    """A table on the card, ready for the kernels, and what it points into
    (``keep``: the inputs, any contiguous copies, and the outputs)."""
    t: torch.Tensor
    leaves: int
    width: int
    units: int
    dev: torch.device
    keep: list


# the columns of K8's table (g, mu, nu, p) and outputs (mu', nu', p'), and
# of K9's (g, p, mu codes, mu scales, nu codes, nu scales; p' and the four)
F32_IN = ((F32, torch.float32),) * 4
F32_OUT = ((F32, torch.float32),) * 3
Q8_IN = ((F32, torch.float32), (F32, torch.float32), (CODES, torch.int8), (SCALES, torch.float32),
         (CODES, torch.uint8), (SCALES, torch.float32))
Q8_OUT = Q8_IN[1:]


def _prepare(ps: Sequence[torch.Tensor], inputs: Sequence, in_kinds, out_kinds,
             names=None) -> Tuple[_Table, List[torch.Tensor], LeafPlan]:
    """The table of a launch on the card over the leaves of ``ps``' shapes:
    the checked inputs' addresses and new flat outputs' (both kept alive
    with the table), copied to the card through pinned memory without a
    host wait (the pinned block stays allocated until the copy is done).
    -> (table, flat outputs, plan)."""
    dev = kernels.require_cuda(ps[0])
    plan = plan_leaves(tuple(p.shape for p in ps))
    keep = []
    cols = [_column(g, names, plan, kind, dt, dev, keep) for g, (kind, dt) in zip(inputs, in_kinds)]
    flats = [_new_flat(plan, kind, dt, dev) for kind, dt in out_kinds]
    keep.append(flats)
    cols += [f.data_ptr() + _byte_offsets(plan, kind) for f, (kind, _) in zip(flats, out_kinds)]
    host = torch.from_numpy(_table(plan, cols)).pin_memory()
    tab = _Table(host.to(dev, non_blocking=True), len(plan.shapes), 1 + len(cols), plan.units,
                 dev, keep)
    return tab, flats, plan


def _scalars(scal: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if scal.device != dev or scal.dtype != torch.float32 or scal.numel() < 4:
        raise ValueError(f"the step's scalars: {scal.dtype} x {scal.numel()} on {scal.device}")
    return scal.contiguous()


def _launch_adam(tab: _Table, scal: torch.Tensor) -> None:
    """K8 over a table of 8 columns, K9 over one of 12."""
    if tab.units == 0:
        return
    scal = _scalars(scal, tab.dev)
    if tab.width == 1 + len(F32_IN) + len(F32_OUT):
        kernels.call(KERNEL, "evt_adam_table", tab.dev, tab.t.data_ptr(), tab.leaves, tab.units,
                     scal.data_ptr(), B1, 1.0 - B1, B2, 1.0 - B2, EPS)
        kernels.count_launch(KERNEL)
    else:
        kernels.call(KERNEL_Q8, "evt_adam_q8_table", tab.dev, tab.t.data_ptr(), tab.leaves,
                     tab.units, scal.data_ptr(), B1, 1.0 - B1, B2, 1.0 - B2, EPS, Q8_LN_EPS,
                     Q8_INV_LN_EPS, q8_inv_steps(127), q8_inv_steps(255), Q8_TINY, Q8_ZERO_BELOW)
        kernels.count_launch(KERNEL_Q8)


def _launch_norm(tab: _Table, max_norm: float) -> torch.Tensor:
    """The norm kernel over a table's gradients -> (clip scale, norm)."""
    buf = torch.empty(2 + NORM_BLOCKS, dtype=torch.float32, device=tab.dev)
    kernels.call(KERNEL_NORM, "evt_grad_norm", tab.dev, tab.t.data_ptr(), tab.leaves, tab.width,
                 tab.units, buf.data_ptr() + 8, buf.data_ptr(), float(np.float32(max_norm)))
    kernels.count_launch(KERNEL_NORM)
    return buf[:2]


def adam_table_plain(gs, mus, nus, ps, scal):
    """Plain version of K8's table launch: :func:`adam_leaf_plain` on each
    work unit of the table, the leaf found by :func:`leaf_of_unit`, into
    flat outputs laid out as the kernel's.  -> (mu's, nu's, p's) lists."""
    plan = plan_leaves(tuple(p.shape for p in ps))
    flats = [_new_flat(plan, kind, dt, ps[0].device) for kind, dt in F32_OUT]
    for _, i, lo, hi in unit_spans(plan):
        part = [t.reshape(-1)[lo:hi] for t in (gs[i], mus[i], nus[i], ps[i])]
        for f, r in zip(flats, adam_leaf_plain(*part, scal)):
            f[plan.offsets[i] + lo:plan.offsets[i] + hi] = r
    return tuple(_flat_views(f, plan) for f in flats)


def adam_table(gs, mus, nus, ps, scal):
    """K8 over lists of float32 leaves in one launch: CPU tensors take
    :func:`adam_table_plain`, CUDA tensors launch the kernel.  ``scal`` is
    the step's device buffer (clip scale, lr, 1-b1^t, 1-b2^t).  -> (mu's,
    nu's, p's) lists, each leaf a view of one flat buffer per kind."""
    if ps[0].device.type == "cpu":
        return adam_table_plain(gs, mus, nus, ps, scal)
    tab, flats, plan = _prepare(ps, (gs, mus, nus, ps), F32_IN, F32_OUT)
    _launch_adam(tab, scal)
    return tuple(_views(f, plan, kind) for f, (kind, _) in zip(flats, F32_OUT))


def adam_table_q8_plain(gs, mqs, mss, nqs, nss, ps, scal):
    """Plain version of K9's table launch: :func:`adam_leaf_q8_plain` on
    each work unit (one codec block) of the table, the leaf found by
    :func:`leaf_of_unit`.  -> (mu codes, mu scales, nu codes, nu scales,
    p's) lists."""
    plan = plan_leaves(tuple(p.shape for p in ps))
    flats = [_new_flat(plan, kind, dt, ps[0].device) for kind, dt in Q8_OUT]
    p_o, mq_o, ms_o, nq_o, ns_o = flats
    for u, i, lo, hi in unit_spans(plan):
        b = u - int(plan.first[i])
        codes = slice(b * Q8_BLOCK, (b + 1) * Q8_BLOCK)
        mq, ms, nq, ns, p = adam_leaf_q8_plain(
            gs[i].reshape(-1)[lo:hi], mqs[i][codes], mss[i].reshape(-1, 1)[b:b + 1],
            nqs[i][codes], nss[i].reshape(-1, 1)[b:b + 1], ps[i].reshape(-1)[lo:hi], scal)
        mq_o[u * Q8_BLOCK:(u + 1) * Q8_BLOCK], nq_o[u * Q8_BLOCK:(u + 1) * Q8_BLOCK] = mq, nq
        ms_o[u], ns_o[u] = ms[0], ns[0]
        p_o[plan.offsets[i] + lo:plan.offsets[i] + hi] = p
    p_o, *moments = (_views(f, plan, kind) for f, (kind, _) in zip(flats, Q8_OUT))
    return (*moments, p_o)


def adam_table_q8(gs, mqs, mss, nqs, nss, ps, scal):
    """K9 over lists of leaves in one launch: CPU tensors take
    :func:`adam_table_q8_plain`, CUDA tensors launch the kernel.  -> (mu
    codes, mu scales, nu codes, nu scales, p's) lists, each leaf a view of
    one flat buffer per kind."""
    if ps[0].device.type == "cpu":
        return adam_table_q8_plain(gs, mqs, mss, nqs, nss, ps, scal)
    tab, flats, plan = _prepare(ps, (gs, ps, mqs, mss, nqs, nss), Q8_IN, Q8_OUT)
    _launch_adam(tab, scal)
    p_o, *moments = (_views(f, plan, kind) for f, (kind, _) in zip(flats, Q8_OUT))
    return (*moments, p_o)


def moment_bytes(state: FusedAdamState) -> int:
    """Device bytes of the two moments (codes and scales for int8)."""
    def tensors(tree):
        for v in tree.values():
            yield from (tensors(v) if isinstance(v, Mapping) else (v,))
    return sum(t.numel() * t.element_size() for m in (state.mu, state.nu) for t in tensors(m))


# ---------------------------------------------------------------- optimizer
def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a dict or a sequence of
    tensors), float32: the plain version of the norm kernel."""
    leaves = grads.values() if isinstance(grads, Mapping) else grads
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def clip_scale_plain(grads, max_norm: float) -> torch.Tensor:
    """(s, ||g||) float32: :func:`global_norm` and optax's clip scale
    ``min(1, max_norm / (||g|| + 1e-16))``."""
    gnorm = global_norm(grads)
    ratio = torch.full_like(gnorm, max_norm) / (gnorm + 1e-16)
    return torch.stack([torch.minimum(torch.ones_like(ratio), ratio), gnorm])


def clip_scale(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """The norm kernel over a list of float32 gradients in one launch: CPU
    tensors take :func:`clip_scale_plain`, CUDA tensors launch the kernel.
    -> (s, ||g||) float32 on their device."""
    grads = list(grads)
    if not grads or grads[0].device.type == "cpu":
        return clip_scale_plain(grads, max_norm)
    tab, _, _ = _prepare(grads, (grads,), F32_IN[:1], ())
    return _launch_norm(tab, max_norm)


def make_fused_adam(learning_rate: Union[float, Callable], max_grad_norm: float = 1.0,
                    moment_dtype: str = "f32") -> FusedAdam:
    """The fused clip + Adam optimizer with moments stored at
    ``moment_dtype`` ("f32", "bf16" or "int8").  ``learning_rate`` is a
    float, which :func:`..train.step.set_learning_rate` may change between
    steps, or a schedule: a function of the int32 step count tensor to a
    float32 tensor on its device, evaluated at the state's count before the
    update (as ``optax.inject_hyperparams``), without a host wait."""
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {MOMENT_DTYPES}, got {moment_dtype!r}")

    def zeros_q8(params: Tensors, dt) -> dict:
        return {"q_tree": {k: torch.zeros(q8_blocks(v.numel()) * Q8_BLOCK, dtype=dt,
                                          device=v.device) for k, v in params.items()},
                "s_tree": {k: torch.zeros((q8_blocks(v.numel()), 1), dtype=torch.float32,
                                          device=v.device) for k, v in params.items()}}

    def init(params: Tensors) -> FusedAdamState:
        dev = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        lr0 = learning_rate(count) if callable(learning_rate) else learning_rate
        if moment_dtype == "int8":
            mu, nu = zeros_q8(params, torch.int8), zeros_q8(params, torch.uint8)
        else:
            dt = torch.bfloat16 if moment_dtype == "bf16" else torch.float32
            mu, nu = ({k: torch.zeros_like(v, dtype=dt) for k, v in params.items()}
                      for _ in range(2))
        return FusedAdamState(
            count=count, mu=mu, nu=nu,
            hyperparams={"learning_rate": torch.as_tensor(lr0, dtype=torch.float32).to(dev)})

    def fused_apply(grads: Tensors, state: FusedAdamState, params: Tensors):
        """-> (new params, new state, global norm).  On the card: the norm
        kernel, then one K8 or K9 launch over one table of every leaf."""
        names = list(params)
        ps = [params[k] for k in names]
        count = state.count + 1
        cf = count.float()
        c1 = 1.0 - torch.pow(torch.full_like(cf, B1), cf)
        c2 = 1.0 - torch.pow(torch.full_like(cf, B2), cf)
        lr = (learning_rate(state.count).float() if callable(learning_rate)
              else state.hyperparams["learning_rate"])
        new_state = lambda mu, nu: FusedAdamState(count, mu, nu, {"learning_rate": lr})  # noqa: E731
        if ps and ps[0].device.type == "cuda" and moment_dtype != "bf16":
            q8 = moment_dtype == "int8"
            mu, nu = state.mu, state.nu
            inputs = ((grads, params, mu["q_tree"], mu["s_tree"], nu["q_tree"], nu["s_tree"])
                      if q8 else (grads, mu, nu, params))
            kinds = (Q8_IN, Q8_OUT) if q8 else (F32_IN, F32_OUT)
            tab, flats, plan = _prepare(ps, inputs, *kinds, names=names)
            sg = _launch_norm(tab, max_grad_norm)
            _launch_adam(tab, torch.stack([sg[0], lr, c1, c2]))
            out = [FlatLeaves(names, f, plan, kind) for f, (kind, _) in zip(flats, kinds[1])]
            if q8:
                p_o, mq, ms, nq, ns = out
                mu, nu = {"q_tree": mq, "s_tree": ms}, {"q_tree": nq, "s_tree": ns}
            else:
                mu, nu, p_o = out
            # the params are read leaf by leaf by the next forward: views now
            return dict(zip(names, _flat_views(p_o.flat, plan))), new_state(mu, nu), sg[1]

        sg = clip_scale([grads[k] for k in names], max_grad_norm)
        scal = torch.stack([sg[0], lr, c1, c2]).float()
        new = {}
        if moment_dtype == "int8":
            mu, nu = ({"q_tree": {}, "s_tree": {}} for _ in range(2))
            for k, p in params.items():
                (mu["q_tree"][k], mu["s_tree"][k], nu["q_tree"][k], nu["s_tree"][k],
                 new[k]) = adam_leaf_q8(grads[k], state.mu["q_tree"][k], state.mu["s_tree"][k],
                                        state.nu["q_tree"][k], state.nu["s_tree"][k], p, scal)
        else:
            mu, nu = {}, {}
            for k, p in params.items():
                if moment_dtype == "bf16":
                    m, v, new[k] = adam_leaf_plain(grads[k], state.mu[k].float(),
                                                   state.nu[k].float(), p, scal)
                    mu[k], nu[k] = m.to(torch.bfloat16), v.to(torch.bfloat16)
                else:
                    mu[k], nu[k], new[k] = adam_leaf(grads[k], state.mu[k], state.nu[k], p,
                                                     scal)
        return new, new_state(mu, nu), sg[1]

    return FusedAdam(init=init, fused_apply=fused_apply)
