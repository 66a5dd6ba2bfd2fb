"""ultralytics YOLOv8 checkpoint -> the JAX package's YOLO params tree.

Port of ``easy_vitpose_tpu/convert/yolo_torch.py``.  Maps the ultralytics
state-dict key layout (model.{i}.conv.weight, model.{i}.bn.*,
model.22.cv2.{l}.{j}.*, ...) onto the tree ``detect/yolo.py`` builds its
``Yolo`` from.  BatchNorm (eps=1e-3 in ultralytics) is folded into conv
weight+bias here, so the runtime graph is pure conv+bias+SiLU.

A released .pt pickles whole ultralytics module objects, so loading one
needs the ultralytics package, which the port does not depend on; without
it the load fails with a message that says to convert the file to .npz
where ultralytics is installed (``python -m
easy_vitpose_tpu_torch.cli.convert yolo``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..detect.yolo import YoloSpec, save_yolo_npz  # noqa: F401  (JAX's module has both)

BN_EPS = 1e-3  # ultralytics BatchNorm2d eps


def _np(t):
    return t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()


def _fold_conv_bn(sd: Mapping[str, np.ndarray], conv_prefix: str,
                  bn_prefix: str) -> Dict[str, np.ndarray]:
    w = _np(sd[conv_prefix + ".weight"]).astype(np.float64)  # (O, I, kh, kw)
    gamma = _np(sd[bn_prefix + ".weight"]).astype(np.float64)
    beta = _np(sd[bn_prefix + ".bias"]).astype(np.float64)
    mean = _np(sd[bn_prefix + ".running_mean"]).astype(np.float64)
    var = _np(sd[bn_prefix + ".running_var"]).astype(np.float64)
    scale = gamma / np.sqrt(var + BN_EPS)
    w = w * scale[:, None, None, None]
    b = beta - mean * scale
    return {"w": w.transpose(2, 3, 1, 0).astype(np.float32),
            "b": b.astype(np.float32)}


def _plain_conv(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    # the detect-head final 1x1s always carry biases in ultralytics — a
    # missing one means layout drift, so no silent zero-fill here
    w = _np(sd[prefix + ".weight"])
    b = _np(sd[prefix + ".bias"])
    return {"w": w.transpose(2, 3, 1, 0).astype(np.float32),
            "b": b.astype(np.float32)}


def _conv_block(sd, prefix):
    """ultralytics Conv = .conv (Conv2d, no bias) + .bn."""
    return _fold_conv_bn(sd, prefix + ".conv", prefix + ".bn")


def _c2f(sd, prefix, n):
    return {
        "cv1": _conv_block(sd, prefix + ".cv1"),
        "cv2": _conv_block(sd, prefix + ".cv2"),
        "m": [{"cv1": _conv_block(sd, f"{prefix}.m.{i}.cv1"),
               "cv2": _conv_block(sd, f"{prefix}.m.{i}.cv2")}
              for i in range(n)],
    }


def infer_scale(sd: Mapping[str, Any]) -> str:
    c0 = _np(sd["model.0.conv.weight"]).shape[0]
    return {16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}[c0]


class _TrackedDict:
    """Mapping shim that records consumed keys and names missing ones —
    the converter indexes only expected keys, so without this audit an
    extra source tensor (wrong scale's depths, an architecture variant)
    would be silently dropped (the reference's loader at least prints
    missing/unexpected keys, vit_utils/util.py:160-171)."""

    def __init__(self, sd):
        self._sd = sd
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        try:
            return self._sd[k]
        except KeyError:
            raise KeyError(
                f"YOLO checkpoint is missing expected key {k!r} — wrong "
                f"--scale/depths for this architecture?") from None

    def __contains__(self, k):
        self.consumed.add(k)
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)


# buffers/constants the math never needs: BN step counters, and the DFL
# 1x1 conv whose weight is the fixed arange(reg_max) expectation filter —
# detect/yolo.py computes the DFL expectation directly
_TOLERATED_UNCONSUMED = (".num_batches_tracked",)
_TOLERATED_KEYS = frozenset({"model.22.dfl.conv.weight"})


def convert_yolo_state_dict(sd: Mapping[str, Any], spec: YoloSpec,
                            strict: bool = True) -> Dict[str, Any]:
    """An ultralytics YOLOv8 state dict -> the params tree, BN folded.
    ``strict`` (default) fails on any source key the converter would not
    read (besides BN counters and the fixed DFL filter)."""
    sd = {k[len("model."):] if k.startswith("model.model.") else k: v
          for k, v in sd.items()}
    if strict:
        sd = _TrackedDict(sd)
    dps = spec.depths
    model: Dict[str, Any] = {}
    for i in ("0", "1", "3", "5", "7", "16", "19"):
        model[i] = _conv_block(sd, f"model.{i}")
    model["2"] = _c2f(sd, "model.2", dps[0])
    model["4"] = _c2f(sd, "model.4", dps[1])
    model["6"] = _c2f(sd, "model.6", dps[1])
    model["8"] = _c2f(sd, "model.8", dps[3])
    model["9"] = {"cv1": _conv_block(sd, "model.9.cv1"),
                  "cv2": _conv_block(sd, "model.9.cv2")}
    for i in ("12", "15", "18", "21"):
        model[i] = _c2f(sd, f"model.{i}", dps[3])
    det: Dict[str, Any] = {"cv2": [], "cv3": []}
    for li in range(3):
        det["cv2"].append([
            _conv_block(sd, f"model.22.cv2.{li}.0"),
            _conv_block(sd, f"model.22.cv2.{li}.1"),
            _plain_conv(sd, f"model.22.cv2.{li}.2"),
        ])
        det["cv3"].append([
            _conv_block(sd, f"model.22.cv3.{li}.0"),
            _conv_block(sd, f"model.22.cv3.{li}.1"),
            _plain_conv(sd, f"model.22.cv3.{li}.2"),
        ])
    model["22"] = det
    if strict:
        unconsumed = sorted(
            k for k in sd if k not in sd.consumed
            and not k.endswith(_TOLERATED_UNCONSUMED)
            and k not in _TOLERATED_KEYS)
        if unconsumed:
            raise ValueError(
                f"YOLO checkpoint has {len(unconsumed)} source key(s) the "
                f"converter would silently drop (scale {spec.scale!r} "
                f"depths mismatch or an architecture variant): "
                + ", ".join(unconsumed[:8])
                + (" ..." if len(unconsumed) > 8 else "")
                + "  (pass strict=False to drop them anyway)")
    return {"model": model}


def load_ultralytics_checkpoint(path: str) -> Tuple[Dict[str, Any], str, int]:
    """Load a yolov8*.pt (the pickled ultralytics model under ``"model"``).
    Returns (params, scale, nc).

    The file is unpickled, which runs the code its classes name: load only
    checkpoints from a source you trust, as with ultralytics itself."""
    import torch
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:  # any unpickling failure: most often no ultralytics
        raise RuntimeError(
            "Loading ultralytics .pt requires the ultralytics package "
            "(pickled modules). Convert to .npz with cli/convert where "
            f"ultralytics is available. Original error: {e}") from e
    model = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    sd = {k: _np(v.float()) for k, v in model.state_dict().items()}
    scale = infer_scale(sd)
    nc = _np(sd["model.22.cv3.0.2.weight"]).shape[0]
    spec = YoloSpec(scale=scale, nc=nc)
    return convert_yolo_state_dict(sd, spec), scale, nc
