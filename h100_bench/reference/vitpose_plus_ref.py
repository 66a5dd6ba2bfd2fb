"""Plain reference of the ViTPose+ pose step on boxes of mixed tasks.

Plain PyTorch in float32 (TF32 off), over a ViTPose+ state dict keyed by
the reference checkpoints' names (``backbone.blocks.{i}.mlp.fc2.*`` the
shared rows, ``backbone.blocks.{i}.mlp.experts.{e}.*`` the expert rows of
dataset e, ``keypoint_head.*`` the first dataset's head and
``associate_keypoint_heads.{e - 1}.*`` the others').  It imports nothing of
the port and nothing of JAX; its crops, blocks, W8A8 linears, heads and UDP
decode are ``vitpose_ref``'s.

From ViTPose++ (arXiv:2212.04246) and the ViTPose repository's ViTMoE: a
block's FFN output for a token of a crop of task t is
``[h @ W_shared^T + b_shared | h @ W_t^T + b_t]``, the two parts side by
side, then the residual; each task has its own head.  The reference runs
one task's crops at a time, in box order, through the backbone with that
task's fc2 (the shared rows with the task's expert rows under them) and
that task's head, then the UDP decode of those crops' maps.

Departures from the published description, as the benchmark serves it:

* W8A8 (``qbits=8``): the spliced fc2 is quantized per output row, which
  gives each of the shared and the expert rows its own scale, as separate
  products would; ``qbits=4`` is the control;
* the decode of a task's crops reads their maps as one flat array (mmpose's
  ``post_dark_udp``: a border peak reads the next map of the same task);
* the published model routes a crop by the dataset it came from; here the
  traffic names each box's task.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from reference.vitpose_ref import (Linears, backbone, crop_geometry, crops,
                                   float32_matmuls, head, udp_decode)

TASKS = ("coco", "aic", "mpii", "ap10k", "apt36k", "wholebody")


def head_prefix(e: int) -> str:
    return "keypoint_head" if e == 0 else f"associate_keypoint_heads.{e - 1}"


def task_weights(p: Dict[str, torch.Tensor], e: int, depth: int) -> Dict[str, torch.Tensor]:
    """The single-task state dict of task ``e``: each fc2 the shared rows
    with expert ``e``'s rows under them, and ``e``'s head as
    ``keypoint_head``."""
    out = {k: v for k, v in p.items()
           if k.startswith("backbone.") and ".mlp.experts." not in k}
    for i in range(depth):
        b = f"backbone.blocks.{i}.mlp"
        for n in ("weight", "bias"):
            out[f"{b}.fc2.{n}"] = torch.cat([p[f"{b}.fc2.{n}"], p[f"{b}.experts.{e}.{n}"]], 0)
    pre = head_prefix(e) + "."
    for k, v in p.items():
        if k.startswith(pre):
            out["keypoint_head." + k[len(pre):]] = v
    return out


def task_groups(tasks: Sequence[int]) -> List[Tuple[int, torch.Tensor]]:
    """(task, the indices of its boxes in box order), for each task with
    boxes, in task order."""
    t = torch.as_tensor(list(tasks), dtype=torch.int64)
    return [(int(e), (t == e).nonzero()[:, 0]) for e in torch.unique(t)]


@torch.no_grad()
def pose(p: Dict[str, torch.Tensor], frame: torch.Tensor, boxes: torch.Tensor,
         tasks: Sequence[int], cfg, qbits: Optional[int], rows: int = 16):
    """The mixed-task step's reference on one frame: (heatmaps by task, as
    {task: (n_t, K_t, 64, 48)}, keypoints (M, K_max, 3) in box order with
    zero rows past each box's K, geometry).  The backbone runs in blocks of
    ``rows`` crops."""
    geo = crop_geometry(boxes, *frame.shape[:2])
    k_max = max(p[f"{head_prefix(e)}.final_layer.weight"].shape[0]
                for e in range(len(TASKS)) if f"{head_prefix(e)}.final_layer.weight" in p)
    kp = torch.zeros((boxes.shape[0], k_max, 3), dtype=torch.float32, device=boxes.device)
    heats = {}
    with float32_matmuls():
        for e, idx in task_groups(tasks):
            pt = task_weights(p, e, cfg["depth"])
            lin = Linears(qbits)         # its cache of integer weights lives with pt
            g = {k: v[idx.to(v.device)] for k, v in geo.items()}
            heat = []
            for i in range(0, len(idx), rows):
                gi = {k: v[i:i + rows] for k, v in g.items()}
                heat.append(head(pt, backbone(pt, crops(frame, gi), cfg, lin), cfg))
            heat = torch.cat(heat)
            heats[e] = heat
            kp[idx.to(kp.device), :heat.shape[1]] = udp_decode(heat, g)
            del pt, lin
    return heats, kp, geo
