"""Inputs made from the seed: frames, boxes and training batches.

Frames are uint8 noise drawn on the device in one call.  Boxes follow the
smoke's ``make_boxes``: random boxes, and five awkward ones first (past the
top-left edge, at the bottom-right edge, a 1-px box on .5 corners for
banker's rounding, one wholly outside the frame, a wide one).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .weights import generator


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def make_boxes(rng: np.random.Generator, M: int, H: int, W: int) -> np.ndarray:
    special = np.array([[-30.0, -40.0, 300.0, 500.0],
                        [W - 250.0, H - 120.0, W + 20.0, H + 5.0],
                        [100.5, 200.5, 101.5, 201.5],
                        [W + 50.0, H + 50.0, W + 90.0, H + 80.0],
                        [10.0, 500.0, 1900.0, 620.0]], np.float32)
    x1 = rng.uniform(0, W - 40, M)
    y1 = rng.uniform(0, H - 40, M)
    w = rng.uniform(20, 700, M)
    h = rng.uniform(20, 900, M)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    n = min(M, len(special))
    boxes[:n] = special[:n]
    return boxes


def noise_frames(seed: int, n: int, H: int, W: int, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 noise frames on ``device``."""
    return torch.randint(0, 256, (n, H, W, 3), dtype=torch.uint8,
                         generator=generator(seed, device), device=device)


def train_batches(seed: int, n: int, B: int, K: int, hw, device) -> Dict[str, torch.Tensor]:
    """``n`` device-input batches stacked on a leading axis: uint8 crops of
    noise, K joints each inside the crop, 85% visible (the finetuner's
    device-input form, rendered by the step)."""
    gen = generator(seed + 1, device)
    H, W = hw
    joints = torch.rand((n, B, K, 2), generator=gen, device=device)
    joints = joints * torch.tensor([W, H], dtype=torch.float32, device=device)
    vis = (torch.rand((n, B, K, 2), generator=gen, device=device) > 0.15).float()
    images = torch.randint(0, 256, (n, B, H, W, 3), dtype=torch.uint8, generator=gen,
                           device=device)
    return {"images_u8": images, "joints": joints, "joints_vis": vis}


def drop_path_masks(seed: int, n: int, depth: int, B: int, rate: float, device) -> torch.Tensor:
    """(n, depth, B, 1, 1) stochastic-depth keep masks pre-scaled by
    1/keep_prob, ``keep_prob = 1 - linspace(0, rate, depth)`` (the
    reference recipe's schedule)."""
    gen = generator(seed + 2, device)
    kp = 1.0 - torch.linspace(0.0, rate, depth, device=device).reshape(1, depth, 1, 1, 1)
    u = torch.rand((n, depth, B, 1, 1), generator=gen, device=device)
    return torch.floor(kp + u) / kp
