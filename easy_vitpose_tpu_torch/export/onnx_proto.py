"""Minimal ONNX protobuf writer/reader — no ``onnx``/``protobuf`` deps.

The port's own copy of ``easy_vitpose_tpu/export/onnx_proto.py``, unchanged
but for this paragraph: the port imports nothing of the JAX package, and
its ONNX files are byte for byte the JAX package's (the producer name
stays the project's).

Why this exists: the reference ships a real ``.onnx`` artifact
(reference export.py:50-60, ``torch.onnx.export`` with a dynamic batch
axis) so non-torch runtimes can consume the model.  This environment has
neither the ``onnx`` package nor ``onnxscript``, so ``torch.onnx.export``
is unavailable both ways — instead we serialize the ONNX ModelProto
directly on the protobuf wire format, which is small and stable:

* a message is a sequence of (tag, value) fields;
  ``tag = (field_number << 3) | wire_type``;
* wire types used here: 0 = varint, 2 = length-delimited (strings, bytes,
  sub-messages, packed repeated scalars).

Field numbers and enums are transcribed from the public ``onnx.proto``
(onnx repo, IR version 8 / proto3 syntax); the subset covers everything a
feed-forward vision graph needs: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto, TypeProto(.Tensor),
TensorShapeProto(.Dimension), OperatorSetIdProto.

A matching decoder (:func:`parse_model`) drives the in-repo numpy
interpreter (``onnx_ref.py``) that validates exported graphs against the
model's forward — the encoder and decoder share the schema tables below, and
tests round-trip through both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# --- TensorProto.DataType (onnx.proto enum) ---
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# --- AttributeProto.AttributeType ---
A_FLOAT, A_INT, A_STRING, A_TENSOR = 1, 2, 3, 4
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    """Unsigned LEB128; negative ints take the proto 10-byte 2's-complement."""
    if n < 0:
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, n: int) -> bytes:
    return _tag(field, 0) + _varint(n)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _f_packed_varints(field: int, ns: Sequence[int]) -> bytes:
    body = b"".join(_varint(n) for n in ns)
    return _f_bytes(field, body)


def _f_fixed32(field: int, f: float) -> bytes:
    return _tag(field, 5) + np.float32(f).tobytes()


# ---------------------------------------------------------------------------
# message builders (field numbers per onnx.proto)
# ---------------------------------------------------------------------------

def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9 (little-endian)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_ONNX:
        raise ValueError(f"unsupported initializer dtype {arr.dtype}")
    out = _f_packed_varints(1, [int(d) for d in arr.shape])
    out += _f_varint(2, _NP_TO_ONNX[arr.dtype])
    out += _f_str(8, name)
    out += _f_bytes(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def _dim(d: Union[int, str]) -> bytes:
    # TensorShapeProto.Dimension: dim_value=1 (int64) | dim_param=2 (string)
    return _f_str(2, d) if isinstance(d, str) else _f_varint(1, d)


def value_info(name: str, elem_type: int,
               dims: Sequence[Union[int, str]]) -> bytes:
    """ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1;
    TypeProto.Tensor: elem_type=1, shape=2; TensorShapeProto.dim=1."""
    shape = b"".join(_f_bytes(1, _dim(d)) for d in dims)
    tensor_type = _f_varint(1, elem_type) + _f_bytes(2, shape)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


def _attribute(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    out = _f_str(1, name)
    if isinstance(value, bool):
        out += _f_varint(3, int(value)) + _f_varint(20, A_INT)
    elif isinstance(value, int):
        out += _f_varint(3, value) + _f_varint(20, A_INT)
    elif isinstance(value, float):
        out += _f_fixed32(2, value) + _f_varint(20, A_FLOAT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_varint(20, A_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, tensor("", value)) + _f_varint(20, A_TENSOR)
    elif isinstance(value, (list, tuple)) and value and all(
            isinstance(v, float) for v in value):
        for v in value:
            out += _f_fixed32(7, v)
        out += _f_varint(20, A_FLOATS)
    elif isinstance(value, (list, tuple)):
        # ints (covers the empty list too; INTS is the common repeated attr)
        out += _f_packed_varints(8, [int(v) for v in value])
        out += _f_varint(20, A_INTS)
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return out


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", **attrs: Any) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_f_str(1, i) for i in inputs)
    out += b"".join(_f_str(2, o) for o in outputs)
    if name:
        out += _f_str(3, name)
    out += _f_str(4, op_type)
    for k, v in attrs.items():
        out += _f_bytes(5, _attribute(k, v))
    return out


def graph(nodes: Sequence[bytes], name: str,
          inputs: Sequence[bytes], outputs: Sequence[bytes],
          initializers: Sequence[bytes],
          doc_string: str = "") -> bytes:
    """GraphProto: node=1, name=2, initializer=5, doc_string=10,
    input=11, output=12."""
    out = b"".join(_f_bytes(1, n) for n in nodes)
    out += _f_str(2, name)
    out += b"".join(_f_bytes(5, t) for t in initializers)
    if doc_string:
        out += _f_str(10, doc_string)
    out += b"".join(_f_bytes(11, vi) for vi in inputs)
    out += b"".join(_f_bytes(12, vi) for vi in outputs)
    return out


def model(graph_bytes: bytes, *, opset: int = 17, ir_version: int = 8,
          producer_name: str = "easy_vitpose_tpu",
          producer_version: str = "", doc_string: str = "") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    model_version=5, doc_string=6, graph=7, opset_import=8
    (OperatorSetIdProto: domain=1, version=2)."""
    out = _f_varint(1, ir_version)
    out += _f_str(2, producer_name)
    if producer_version:
        out += _f_str(3, producer_version)
    if doc_string:
        out += _f_str(6, doc_string)
    out += _f_bytes(7, graph_bytes)
    out += _f_bytes(8, _f_str(1, "") + _f_varint(2, opset))
    return out


# ---------------------------------------------------------------------------
# decoder (drives onnx_ref.py and the round-trip tests)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str
    attrs: Dict[str, Any]


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    name: str
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, int, List[Union[int, str]]]]
    outputs: List[Tuple[str, int, List[Union[int, str]]]]


@dataclasses.dataclass
class Model:
    ir_version: int
    opset: int
    producer_name: str
    graph: Graph


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(data, pos)
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = data[pos:pos + 4]
            pos += 4
        elif wire == 1:
            v = data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _unpack_varints(v: Union[int, bytes]) -> List[int]:
    """A repeated varint field arrives packed (bytes) or single (int)."""
    if isinstance(v, int):
        return [v]
    out, pos = [], 0
    while pos < len(v):
        n, pos = _read_varint(v, pos)
        out.append(n)
    return out


def _signed(n: int) -> int:
    return n - (1 << 64) if n >= (1 << 63) else n


def _parse_tensor(data: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = FLOAT
    name = ""
    raw = b""
    float_data: List[float] = []
    int64_data: List[int] = []
    for field, wire, v in _fields(data):
        if field == 1:
            dims += [_signed(x) for x in _unpack_varints(v)]
        elif field == 2:
            dtype = v
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
        elif field == 4:   # float_data (packed fixed32)
            float_data += list(np.frombuffer(v, "<f4"))
        elif field == 7:   # int64_data
            int64_data += [_signed(x) for x in _unpack_varints(v)]
    np_dtype = _ONNX_TO_NP[dtype]
    if raw:
        arr = np.frombuffer(raw, np_dtype.newbyteorder("<")).astype(np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np_dtype)
    else:
        arr = np.asarray(int64_data, np_dtype)
    return name, arr.reshape(dims)


def _parse_attr(data: bytes) -> Tuple[str, Any]:
    name = ""
    val: Any = None
    ints: List[int] = []
    floats: List[float] = []
    atype: Optional[int] = None
    for field, wire, v in _fields(data):
        if field == 1:
            name = v.decode()
        elif field == 2:
            val = float(np.frombuffer(v, "<f4")[0])
        elif field == 3:
            val = _signed(v)
        elif field == 4:
            val = v.decode()
        elif field == 5:
            val = _parse_tensor(v)[1]
        elif field == 7:
            # repeated float arrives packed (wire 2: one length-delimited
            # blob of fixed32s — how torch/onnx emit it) or unpacked
            # (wire 5: one fixed32 per field occurrence — how we emit it)
            floats += [float(f) for f in np.frombuffer(v, "<f4")]
        elif field == 8:
            ints += [_signed(x) for x in _unpack_varints(v)]
        elif field == 20:
            atype = v
    if atype == A_INTS or (val is None and ints):
        val = ints
    elif atype == A_FLOATS or (val is None and floats):
        val = floats
    return name, val


def _parse_node(data: bytes) -> Node:
    n = Node("", [], [], "", {})
    for field, wire, v in _fields(data):
        if field == 1:
            n.inputs.append(v.decode())
        elif field == 2:
            n.outputs.append(v.decode())
        elif field == 3:
            n.name = v.decode()
        elif field == 4:
            n.op_type = v.decode()
        elif field == 5:
            k, a = _parse_attr(v)
            n.attrs[k] = a
    return n


def _parse_value_info(data: bytes) -> Tuple[str, int, List[Union[int, str]]]:
    name, elem, dims = "", FLOAT, []
    for field, wire, v in _fields(data):
        if field == 1:
            name = v.decode()
        elif field == 2:
            for f2, w2, v2 in _fields(v):       # TypeProto
                if f2 == 1:                     # tensor_type
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:           # shape
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1:     # dim
                                    dv: Union[int, str] = -1
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = _signed(v5)
                                        elif f5 == 2:
                                            dv = v5.decode()
                                    dims.append(dv)
    return name, elem, dims


def _parse_graph(data: bytes) -> Graph:
    g = Graph([], "", {}, [], [])
    for field, wire, v in _fields(data):
        if field == 1:
            g.nodes.append(_parse_node(v))
        elif field == 2:
            g.name = v.decode()
        elif field == 5:
            name, arr = _parse_tensor(v)
            g.initializers[name] = arr
        elif field == 11:
            g.inputs.append(_parse_value_info(v))
        elif field == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(data: bytes) -> Model:
    ir, opset, producer = 0, 0, ""
    g: Optional[Graph] = None
    for field, wire, v in _fields(data):
        if field == 1:
            ir = v
        elif field == 2:
            producer = v.decode()
        elif field == 7:
            g = _parse_graph(v)
        elif field == 8:
            for f2, w2, v2 in _fields(v):
                if f2 == 2:
                    opset = v2
    assert g is not None, "ModelProto has no graph"
    return Model(ir, opset, producer, g)
