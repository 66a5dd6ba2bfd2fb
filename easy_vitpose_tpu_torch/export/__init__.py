"""Export backends of the port.

* ``onnx_vitpose`` — a real ``.onnx`` artifact for runtimes outside torch
  (the reference's ``torch.onnx.export`` path, reference export.py:50-60),
  written by a dependency-free protobuf serializer (``onnx_proto``) and
  validated by an independent numpy ONNX interpreter (``onnx_ref``).
* The ``torch.export`` path (a ``.pt2`` of the forward's plain ops for a
  fixed batch) lives in ``cli/export.py``.
"""
from .onnx_vitpose import vitpose_to_onnx  # noqa: F401
