"""Random ViTPose weights made on the device from the seed.

The rules are those of the port's ``models/vitpose.py::init_tensor`` (so
that the heatmaps span an O(1) range and every term of every kernel is
exercised): linear and patch weights and the position embedding
truncated-normal 0.02, LN and BN scales 1 + 0.1 N(0, 1), biases and BN
means 0.02 N(0, 1), BN variances U(0.5, 1.5), the head's convolutions
N(0, 1) over the root of their fan-in.  The draws are two large calls on
one ``torch.Generator`` on the device (a normal and a uniform vector over
every element), so set-up makes ViT-L's 300 M values in milliseconds; each
leaf is a slice of them, in state-dict order.  Truncation folds the normal
into (-2, 2) with ``fmod``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def vitpose_shapes(cfg) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every state-dict entry of the port's
    ``ViTPose(cfg)``, without allocating it."""
    from easy_vitpose_tpu_torch.models.vitpose import ViTPose

    with torch.device("meta"):
        model = ViTPose(cfg)
    return [(k, tuple(v.shape), v.dtype) for k, v in model.state_dict().items()]


def _leaf(name: str, shape, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    if name.endswith("running_var"):
        return 0.5 + u
    if "deconv_layers" in name and len(shape) == 4:
        return z / math.sqrt(shape[0] * 4)
    if "final_layer.weight" in name:
        return z / math.sqrt(math.prod(shape[1:]))
    if len(shape) >= 2 or name.endswith("pos_embed"):
        return torch.fmod(z, 2.0) * 0.02
    if name.endswith("weight"):
        return 1.0 + 0.1 * z
    return 0.02 * z


def vitpose_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 state dict of a ViTPose of ``cfg`` from ``seed``."""
    shapes = vitpose_shapes(cfg)
    total = sum(math.prod(s) for _, s, dt in shapes if dt.is_floating_point)
    gen = generator(seed, device)
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, dt in shapes:
        if not dt.is_floating_point:           # num_batches_tracked
            out[name] = torch.zeros(shape, dtype=dt, device=device)
            continue
        n = math.prod(shape)
        out[name] = _leaf(name, shape, z[at:at + n], u[at:at + n]).reshape(shape).clone()
        at += n
    return out


def vitpose_model(cfg, weights: Dict[str, torch.Tensor], device):
    """The port's float32 ``ViTPose`` holding ``weights``."""
    from easy_vitpose_tpu_torch.models.vitpose import ViTPose

    with torch.device("meta"):
        model = ViTPose(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model.eval()


def port_config(c: dict):
    """The port's ``ModelConfig`` of a configuration file's sizes."""
    from easy_vitpose_tpu_torch.configs import BackboneConfig, HeadConfig, ModelConfig

    bb = BackboneConfig(embed_dim=c["embed_dim"], depth=c["depth"], num_heads=c["num_heads"],
                        mlp_ratio=c["mlp_ratio"], qkv_bias=c["qkv_bias"],
                        drop_path_rate=c["drop_path_rate"], patch_size=c["patch_size"],
                        patch_padding=c["patch_padding"], img_size=tuple(c["img_size"]),
                        layer_norm_eps=c["layer_norm_eps"])
    head = HeadConfig(in_channels=c["embed_dim"], num_keypoints=c["num_keypoints"],
                      deconv_filters=tuple(c["deconv_filters"]),
                      deconv_kernels=tuple(c["deconv_kernels"]),
                      final_conv_kernel=c["final_conv_kernel"])
    return ModelConfig(name=c["size"], dataset=c["dataset"], backbone=bb, head=head)
