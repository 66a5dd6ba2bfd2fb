"""Typed model configs of the PyTorch port.

The port's own copy of the constants and dataclasses of
``easy_vitpose_tpu/configs.py``; the port imports nothing of the JAX package.
The hybrid CNN stem and the "simple" head variant have their fields, for
the code that must refuse them, and are not ported yet (ROADMAP A12, A15).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

IMAGE_SIZE: Tuple[int, int] = (192, 256)   # (W, H) of the pose crop
HEATMAP_SIZE: Tuple[int, int] = (48, 64)   # (W, H) of the output heatmaps
PATCH_SIZE = 16
PATCH_PADDING = 2   # the reference's 4+2*(ratio//2-1) padding at ratio 1

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

MODEL_ABBR = {"s": "small", "b": "base", "l": "large", "h": "huge"}

DATASETS = ("coco", "coco_25", "wholebody", "mpii", "aic", "ap10k", "apt36k", "custom")

NUM_KEYPOINTS = {
    "coco": 17,
    "coco_25": 25,
    "wholebody": 133,
    "mpii": 16,
    "aic": 14,
    "ap10k": 17,
    "apt36k": 17,
    "custom": 18,
}


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """ViT backbone hyper-parameters."""

    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0   # stochastic depth, training only
    patch_size: int = PATCH_SIZE
    patch_padding: int = PATCH_PADDING
    img_size: Tuple[int, int] = (256, 192)  # (H, W)
    in_chans: int = 3
    layer_norm_eps: float = 1e-6
    # the hybrid CNN-stem embedding (reference HybridEmbed); not ported
    # (ROADMAP A12): ``ViT`` and the ONNX export refuse it
    stem_channels: Optional[Tuple[int, ...]] = None

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_shape(self) -> Tuple[int, int]:
        """(Hp, Wp) token grid. 256x192/p16/pad2 -> (16, 12) = 192 tokens."""
        h = (self.img_size[0] + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1
        w = (self.img_size[1] + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1
        return (h, w)

    @property
    def num_tokens(self) -> int:
        hp, wp = self.patch_shape
        return hp * wp


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Deconv heatmap head: ConvTranspose(k4, s2) + BN + ReLU stages, then a
    ``final_conv_kernel`` conv to ``num_keypoints`` channels."""

    in_channels: int
    num_keypoints: int
    deconv_filters: Tuple[int, ...] = (256, 256)
    deconv_kernels: Tuple[int, ...] = (4, 4)
    final_conv_kernel: int = 1
    # the "simple" head's x4 upsample (no deconvs); not ported (ROADMAP
    # A15): ``Head`` and the ONNX export refuse it
    upsample: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str                 # e.g. "b"
    dataset: str              # e.g. "coco"
    backbone: BackboneConfig
    head: HeadConfig

    @property
    def num_keypoints(self) -> int:
        return self.head.num_keypoints


_BACKBONES = {
    "s": BackboneConfig(embed_dim=384, depth=12, num_heads=12, drop_path_rate=0.1),
    "b": BackboneConfig(embed_dim=768, depth=12, num_heads=12, drop_path_rate=0.3),
    "l": BackboneConfig(embed_dim=1024, depth=24, num_heads=16, drop_path_rate=0.5),
    "h": BackboneConfig(embed_dim=1280, depth=32, num_heads=16, drop_path_rate=0.55),
}


def get_model_config(dataset: str, size: str, *,
                     num_keypoints: Optional[int] = None) -> ModelConfig:
    """Config for ``(dataset, size)``, e.g. ``get_model_config("coco", "b")``."""
    if size not in _BACKBONES:
        raise ValueError(f"model size {size!r} not in {list(_BACKBONES)}")
    if dataset not in DATASETS:
        raise ValueError(f"dataset {dataset!r} not in {DATASETS}")
    bb = _BACKBONES[size]
    k = num_keypoints if num_keypoints is not None else NUM_KEYPOINTS[dataset]
    head = HeadConfig(in_channels=bb.embed_dim, num_keypoints=k)
    return ModelConfig(name=size, dataset=dataset, backbone=bb, head=head)


def infer_dataset_by_path(model_path: str) -> str:
    """The dataset named in a checkpoint's file name, e.g.
    ``vitpose-b-coco_25.pth`` -> ``coco_25``."""
    name = os.path.basename(model_path)
    m = re.search(r"-([a-zA-Z0-9_]+)\.(pth|onnx|engine|npz|safetensors|orbax)", name)
    if not m:
        raise ValueError(
            f"Could not infer the dataset from ckpt name {name!r}; pass dataset=...")
    return m.group(1)


# detection class -> COCO class ids for the detector
# (reference: easy_ViTPose/inference.py:36-48)
DETC_TO_YOLO_YOLOC = {
    "human": [0],
    "cat": [15],
    "dog": [16],
    "horse": [17],
    "sheep": [18],
    "cow": [19],
    "elephant": [20],
    "bear": [21],
    "zebra": [22],
    "giraffe": [23],
    "animals": [15, 16, 17, 18, 19, 20, 21, 22, 23],
}
