"""The ViTPose forward as a ``torch.export`` program (``.pt2``).

The port's counterpart of the JAX package's ``cli/export.py --format aot``
artifact (a ``jax.export`` of the forward for a fixed crop batch).  JAX's
artifact holds XLA's twin of each block (``block_impl="xla"`` /
``"xla_q8"``), not the Pallas kernel, so that it runs on any backend; the
``.pt2`` likewise holds the forward's plain ops
(``vitpose_forward(..., plain=True)``: the kernels' plain versions), not
the hand-written kernels, whose ctypes launches ``torch.export`` cannot
trace.  It loads with ``torch.export.load`` alone and runs on the device it
was exported on; an int8 export carries the W8A8 weights (int8 with their
float32 scales) as buffers.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs import IMAGE_SIZE
from ..models.vitpose import ViTPose, compute_dtype, vitpose_forward


class PlainForward(nn.Module):
    """``vitpose_forward(model, x, plain=True)`` as a module: (B, 256, 192,
    3) normalized NHWC crops in the model's compute dtype -> (B, K, 64, 48)
    heatmaps in that dtype."""

    def __init__(self, model: ViTPose):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vitpose_forward(self.model, x, plain=True)


def export_forward(model: ViTPose, batch: int) -> "torch.export.ExportedProgram":
    """The plain forward of a serving copy (fp32, bf16 or int8) on its
    device, exported for ``batch`` crops."""
    W, H = IMAGE_SIZE
    x = torch.zeros((batch, H, W, 3), dtype=compute_dtype(model),
                    device=model.backbone.pos_embed.device)
    with torch.no_grad():
        return torch.export.export(PlainForward(model.eval()), (x,))
