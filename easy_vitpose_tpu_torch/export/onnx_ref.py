"""Independent numpy ONNX interpreter for the exported op subset.

The port's own copy of ``easy_vitpose_tpu/export/onnx_ref.py``, unchanged
but for its docstring.  Like the original it binds only the first output
of every op but Split (``env[n.outputs[0]]`` in ``_run_node``): the
optional extra outputs of LayerNormalization or BatchNormalization are
dropped, which the exported graphs never read.

This environment has no onnxruntime, so the exported ``.onnx`` bytes are
validated by executing them with this interpreter — a from-the-spec numpy
transcription of each op's semantics (onnx.ai/onnx/operators) — and
comparing against the port's forward (tests/test_torch_export.py).  It shares
no code with the graph builder beyond the wire-format parser, so a
builder bug (wrong layout, wrong attribute, wrong op choice) shows up as
a numeric mismatch instead of passing silently.

Supported ops (opset 13-17 semantics): Conv, ConvTranspose,
BatchNormalization, Relu, LayerNormalization, MatMul, Add, Mul, Div,
Sub, Erf, Split, Reshape, Transpose, Softmax.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np

try:
    from scipy.special import erf as _erf
except ImportError:                                    # pragma: no cover
    import math
    _erf = np.vectorize(math.erf)

from .onnx_proto import Model, Node, parse_model


def _conv2d(x: np.ndarray, w: np.ndarray, b, strides, pads) -> np.ndarray:
    """Conv: x (B,C,H,W), w OIHW, pads [t,l,b,r]."""
    sh, sw = strides
    t, l, bo, r = pads
    xp = np.pad(x, ((0, 0), (0, 0), (t, bo), (l, r)))
    kh, kw = w.shape[2:]
    win = np.lib.stride_tricks.sliding_window_view(xp, (kh, kw), axis=(2, 3))
    win = win[:, :, ::sh, ::sw]                        # (B,C,Ho,Wo,kh,kw)
    y = np.einsum("bcijkl,ockl->boij", win, w, optimize=True)
    if b is not None:
        y = y + b[None, :, None, None]
    return y.astype(np.float32)


def _conv_transpose2d(x: np.ndarray, w: np.ndarray, b, strides,
                      pads) -> np.ndarray:
    """ConvTranspose: x (B,C,H,W), w IOHW (torch layout), output_padding=0.

    Realized as zero-stuffing by the stride then correlating with the
    spatially-flipped kernel (the textbook equivalence the spec defines
    through the gradient-of-conv relation).
    """
    B, C, H, W = x.shape
    sh, sw = strides
    kh, kw = w.shape[2:]
    up = np.zeros((B, C, (H - 1) * sh + 1, (W - 1) * sw + 1), np.float32)
    up[:, :, ::sh, ::sw] = x
    wf = w[:, :, ::-1, ::-1].transpose(1, 0, 2, 3)     # -> OIHW, flipped
    t, l, bo, r = pads
    full = [kh - 1 - t, kw - 1 - l, kh - 1 - bo, kw - 1 - r]
    return _conv2d(up, np.ascontiguousarray(wf), b, (1, 1),
                   (full[0], full[1], full[2], full[3]))


# Attributes each op is allowed to carry.  Anything outside the set is a
# hard error: silently defaulting an unhandled attribute (group, dilations,
# output_padding, auto_pad, ...) would let a builder bug pass validation
# while onnxruntime honors the attribute and computes something else.
_ALLOWED_ATTRS: Dict[str, frozenset] = {
    "Conv": frozenset({"strides", "pads", "kernel_shape"}),
    "ConvTranspose": frozenset({"strides", "pads", "kernel_shape"}),
    "BatchNormalization": frozenset({"epsilon"}),
    "Relu": frozenset(),
    "LayerNormalization": frozenset({"axis", "epsilon"}),
    "MatMul": frozenset(),
    "Add": frozenset(),
    "Sub": frozenset(),
    "Mul": frozenset(),
    "Div": frozenset(),
    "Erf": frozenset(),
    "Split": frozenset({"axis", "split"}),
    "Reshape": frozenset({"allowzero"}),
    "Transpose": frozenset({"perm"}),
    "Softmax": frozenset({"axis"}),
}


def _run_node(n: Node, env: Dict[str, np.ndarray]) -> None:
    op, a = n.op_type, n.attrs
    extra = set(a) - _ALLOWED_ATTRS.get(op, frozenset())
    if extra:
        raise NotImplementedError(
            f"op {op} carries unhandled attribute(s) {sorted(extra)} — "
            f"the interpreter would silently ignore them")
    x = [env[i] for i in n.inputs if i]

    if op == "Conv":
        y = _conv2d(x[0], x[1], x[2] if len(x) > 2 else None,
                    a.get("strides", [1, 1]), a.get("pads", [0, 0, 0, 0]))
    elif op == "ConvTranspose":
        y = _conv_transpose2d(x[0], x[1], x[2] if len(x) > 2 else None,
                              a.get("strides", [1, 1]),
                              a.get("pads", [0, 0, 0, 0]))
    elif op == "BatchNormalization":
        X, s, b, m, v = x
        eps = a.get("epsilon", 1e-5)
        sh = (1, -1) + (1,) * (X.ndim - 2)
        y = (X - m.reshape(sh)) / np.sqrt(v.reshape(sh) + eps) \
            * s.reshape(sh) + b.reshape(sh)
    elif op == "Relu":
        y = np.maximum(x[0], 0)
    elif op == "LayerNormalization":
        # spec: normalize over ALL axes from 'axis' to the end, not just one
        axis = a.get("axis", -1)
        eps = a.get("epsilon", 1e-5)
        X = x[0].astype(np.float32)
        axes = tuple(range(axis % X.ndim, X.ndim))
        mean = X.mean(axis=axes, keepdims=True)
        var = ((X - mean) ** 2).mean(axis=axes, keepdims=True)
        y = (X - mean) / np.sqrt(var + eps) * x[1] + x[2]
    elif op == "MatMul":
        y = np.matmul(x[0], x[1])
    elif op == "Add":
        y = x[0] + x[1]
    elif op == "Sub":
        y = x[0] - x[1]
    elif op == "Mul":
        y = x[0] * x[1]
    elif op == "Div":
        y = x[0] / x[1]
    elif op == "Erf":
        y = _erf(x[0]).astype(np.float32)
    elif op == "Split":
        axis = a.get("axis", 0)
        k = len(n.outputs)
        sizes = a.get("split") or (x[1].tolist() if len(x) > 1 else None)
        if sizes:
            splits = np.cumsum(sizes[:-1])
        else:
            assert x[0].shape[axis] % k == 0
            splits = k
        parts = np.split(x[0], splits, axis=axis)
        for name, p in zip(n.outputs, parts):
            env[name] = np.ascontiguousarray(p)
        return
    elif op == "Reshape":
        shape = [int(d) for d in x[1]]
        if not a.get("allowzero", 0):
            shape = [x[0].shape[i] if d == 0 else d
                     for i, d in enumerate(shape)]
        y = x[0].reshape(shape)
    elif op == "Transpose":
        y = np.transpose(x[0], a["perm"])
    elif op == "Softmax":
        axis = a.get("axis", -1)
        e = np.exp(x[0] - x[0].max(axis=axis, keepdims=True))
        y = e / e.sum(axis=axis, keepdims=True)
    else:
        raise NotImplementedError(f"op {op} not in the interpreter subset")
    env[n.outputs[0]] = np.asarray(y, np.float32) \
        if y.dtype == np.float64 else y


def run_model(model: "Model | bytes",
              feeds: Mapping[str, np.ndarray]) -> List[np.ndarray]:
    """Execute an ONNX model on numpy inputs; returns the graph outputs."""
    if isinstance(model, (bytes, bytearray)):
        model = parse_model(bytes(model))
    g = model.graph
    env: Dict[str, np.ndarray] = dict(g.initializers)
    for name, _, _ in g.inputs:
        env[name] = np.asarray(feeds[name])
    for n in g.nodes:                   # nodes are topologically sorted
        _run_node(n, env)
    return [env[name] for name, _, _ in g.outputs]
