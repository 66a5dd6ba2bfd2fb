"""The YOLOv8 detector in PyTorch, with hand-written letterbox and NMS kernels.

Port of ``easy_vitpose_tpu/detect/yolo.py``.  Its public functions keep the
JAX package's layouts and names: :func:`yolo_forward` takes (B, H, W, 3)
NHWC input and returns NHWC head outputs, :func:`decode_detections` and
:func:`nms_fixed_plain` return what their JAX namesakes return, and the
packed detections are (max_det, 7) rows ``[x1, y1, x2, y2, conf, cls,
valid]``, score-sorted with the kept rows first.  Inside, the network is a
tree of ``nn.Module``\\ s that mirrors the JAX params tree, run as NCHW
tensors in the ``channels_last`` memory format on ``F.conv2d`` and
``F.max_pool2d`` (cuDNN on the card), which JAX computes outside any Pallas
kernel too.

Two of JAX's XLA stages are kernels written for the card:

* D1, the letterbox (``csrc/letterbox.cu``, replacing ``letterbox_sample``
  and the divide by 255 of ``detect_frame_core``, and their vmap in
  ``detect_batch_core``): one launch from the uint8 frame, or a stack of S
  frames of one size, to the detector's input; :func:`letterbox_input_plain`
  is its plain version.
* D2, greedy NMS (``csrc/nms.cu``, replacing ``nms_fixed`` and the
  un-letterbox of ``detect_frame_core``, and their vmap in
  ``detect_batch_core``): one block per frame builds the IoU bitmask of its
  score-sorted candidates in shared memory and one warp sweeps it;
  :func:`nms_packed_plain` is its plain version, JAX's Jacobi fixpoint.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel, or raises, for a CUDA tensor.  The rest (convolutions, SiLU,
pooling, upsampling, the DFL decode, the class gate, the stable sort) are
PyTorch calls.  Nothing between the frame's upload and the packed rows makes
the host wait: the per-device constants are made once.  On the card,
``YoloDetector.detect_async`` and ``detect_batch_async`` replay one CUDA
graph per frame shape (``pipeline/graphs.py``), the counterpart of JAX's
``detect_frame_jit`` and ``detect_batch_jit``.

Numerics: the float32 detector's convolutions run in float32 and on
cuDNN's deterministic algorithms whatever the caller's flags say (PyTorch's
``torch.backends.cudnn.allow_tf32`` is True by default, and TF32 keeps
about three decimal digits): :func:`yolo_forward` runs inside
``utils/precision.py::float32_convolutions``, which sets both for its
duration and restores the caller's settings, eagerly and in a captured
graph alike.  At bfloat16, each convolution runs in bf16, adds its
float32 bias (promoting), rounds back to bf16 and then applies SiLU, as
``conv_bn_silu`` does in JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..utils.precision import float32_convolutions

# scale -> (depth_mult, width_mult, max_channels)
SCALES = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.0, 512),
    "x": (1.0, 1.25, 512),
}

REG_MAX = 16
STRIDES = (8, 16, 32)
LETTERBOX_FILL = 114.0
NUM_CLASSES = 80  # COCO
CLASS_OFFSET = 7680.0  # per-class coordinate shift of the class-aware NMS

SMEM_LIMIT = 232448 - 64   # D2's dynamic shared memory: 227 KB less its counters


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(round(x / divisor) * divisor))


def scale_channels(c: int, w: float, max_ch: int) -> int:
    return _make_divisible(min(c, max_ch) * w)


def scale_depth(n: int, d: float) -> int:
    return max(1, round(n * d)) if n > 1 else n


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    scale: str
    nc: int = NUM_CLASSES

    @property
    def widths(self) -> Tuple[int, ...]:
        d, w, mc = SCALES[self.scale]
        return tuple(scale_channels(c, w, mc) for c in (64, 128, 256, 512, 1024))

    @property
    def depths(self) -> Tuple[int, ...]:
        d, _, _ = SCALES[self.scale]
        return tuple(scale_depth(n, d) for n in (3, 6, 6, 3))


def detect_head_channels(spec: YoloSpec) -> Tuple[int, int]:
    """(c2, c3) hidden widths of the Detect branches (ultralytics formula)."""
    ch0 = spec.widths[2]  # P3 channels
    c2 = max(16, ch0 // 4, 4 * REG_MAX)
    c3 = max(ch0, min(spec.nc, 100))
    return c2, c3


# --------------------------------------------------------------- weights

class Conv(nn.Module):
    """One convolution with its BatchNorm folded in: an OIHW weight in the
    detector's dtype (``channels_last``) and a float32 bias."""

    def __init__(self, w_hwio: np.ndarray, b: np.ndarray, dtype: torch.dtype):
        super().__init__()
        w = torch.from_numpy(np.ascontiguousarray(np.asarray(w_hwio, np.float32)
                                                  .transpose(3, 2, 0, 1)))
        self.register_buffer("weight", w.to(dtype).contiguous(memory_format=torch.channels_last))
        self.register_buffer("bias", torch.from_numpy(np.asarray(b, np.float32).copy()))

    def forward(self, x: torch.Tensor, stride: int = 1, act: bool = True) -> torch.Tensor:
        """Conv + bias + SiLU, SAME-style autopad: the convolution in the
        input's dtype, the float32 bias added (promoting), the sum rounded
        back to the input's dtype, then SiLU."""
        k = self.weight.shape[-1]
        y = F.conv2d(x, self.weight, stride=stride, padding=(k - 1) // 2)
        y = (y + self.bias[:, None, None]).to(x.dtype)
        return F.silu(y) if act else y


def _module_tree(node, dtype: torch.dtype) -> nn.Module:
    """The JAX params tree as modules: dicts become ``ModuleDict``, lists
    ``ModuleList``, {"w", "b"} leaves :class:`Conv`; so ``p["cv1"]`` and
    ``p["m"][i]`` index both alike."""
    if isinstance(node, dict) and set(node) == {"w", "b"}:
        return Conv(node["w"], node["b"], dtype)
    if isinstance(node, dict):
        return nn.ModuleDict({k: _module_tree(v, dtype) for k, v in node.items()})
    return nn.ModuleList([_module_tree(v, dtype) for v in node])


class Yolo(nn.Module):
    """The detector's weights: ``model`` mirrors the JAX tree's "model"."""

    def __init__(self, params: Dict[str, Any], spec: YoloSpec, dtype: torch.dtype):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        self.model = _module_tree(params["model"], dtype)


def yolo_params_from_jax(params: Dict[str, Any], spec: YoloSpec,
                         dtype: torch.dtype = torch.float32, device=None) -> Yolo:
    """JAX YOLO params (a tree of numpy arrays, convolutions HWIO with BN
    folded, as ``convert/yolo_torch.py`` writes them) -> :class:`Yolo` with
    OIHW weights in ``dtype`` and float32 biases, on ``device`` (the CPU if
    None)."""
    model = Yolo(params, spec, dtype)
    return model if device is None else model.to(device)


def init_yolo_params(seed: int, spec: YoloSpec, frame: Optional[np.ndarray] = None,
                     imgsz: int = 320, cls_gain: float = 1.5,
                     cls_prior: float = -4.0) -> Dict[str, Any]:
    """Random params drawn with numpy from ``seed``, in the JAX tree layout
    (HWIO weights, float32 biases of std 0.1), scaled as a trained network
    with its BatchNorm folded is: each output channel of each convolution
    is divided by its standard deviation on ``frame`` (an (H, W, 3) uint8
    image, letterboxed to ``imgsz``; a (imgsz, imgsz) uniform noise input
    drawn from the seed if None), layer by layer in forward order, so every
    channel has unit spread on it.  The class logits then get ``cls_gain``
    times that spread and biases at ``cls_prior`` (the prior-probability
    bias of a trained head), so a frame gives scores spread over (0, 1) with
    a few percent above the gates, not all alike.  (Per output channel,
    as a folded BatchNorm scales a trained network.)"""
    rng = np.random.default_rng(seed)
    wds, dps = spec.widths, spec.depths

    def conv(cin, cout, k, bias=0.0):
        w = rng.standard_normal((k, k, cin, cout)) / math.sqrt(cin * k * k)
        return {"w": w.astype(np.float32),
                "b": (bias + 0.1 * rng.standard_normal(cout)).astype(np.float32)}

    def c2f_p(cin, cout, n):
        c = cout // 2
        return {"cv1": conv(cin, 2 * c, 1), "cv2": conv((2 + n) * c, cout, 1),
                "m": [{"cv1": conv(c, c, 3), "cv2": conv(c, c, 3)} for _ in range(n)]}

    c2, c3 = detect_head_channels(spec)
    p3, p4, p5 = wds[2], wds[3], wds[4]
    model = {
        "0": conv(3, wds[0], 3), "1": conv(wds[0], wds[1], 3),
        "2": c2f_p(wds[1], wds[1], dps[0]), "3": conv(wds[1], wds[2], 3),
        "4": c2f_p(wds[2], wds[2], dps[1]), "5": conv(wds[2], wds[3], 3),
        "6": c2f_p(wds[3], wds[3], dps[1]), "7": conv(wds[3], wds[4], 3),
        "8": c2f_p(wds[4], wds[4], dps[3]),
        "9": {"cv1": conv(wds[4], wds[4] // 2, 1), "cv2": conv(wds[4] // 2 * 4, wds[4], 1)},
        "12": c2f_p(p4 + p5, p4, dps[3]), "15": c2f_p(p3 + p4, p3, dps[3]),
        "16": conv(p3, p3, 3), "18": c2f_p(p3 + p4, p4, dps[3]),
        "19": conv(p4, p4, 3), "21": c2f_p(p4 + p5, p5, dps[3]),
        "22": {"cv2": [[conv(c, c2, 3), conv(c2, c2, 3), conv(c2, 4 * REG_MAX, 1)]
                       for c in (p3, p4, p5)],
               "cv3": [[conv(c, c3, 3), conv(c3, c3, 3), conv(c3, spec.nc, 1, cls_prior)]
                       for c in (p3, p4, p5)]},
    }
    params = {"model": model}
    cls_heads = {id(level[2]) for level in model["22"]["cv3"]}
    if frame is None:
        x = torch.from_numpy(rng.random((1, imgsz, imgsz, 3), dtype=np.float32)).permute(0, 3, 1, 2)
    else:
        geom = letterbox_geometry(frame.shape[0], frame.shape[1], imgsz)
        x = letterbox_input_plain(torch.from_numpy(np.ascontiguousarray(frame)), geom)
    yolo = Yolo(params, spec, torch.float32)
    pairs = list(zip(_conv_leaves(params), _conv_modules(yolo)))
    by_module = {id(m): leaf for leaf, m in pairs}

    def unit_spread(m: Conv, args):
        x_in, stride = args[0], args[1] if len(args) > 1 else 1
        k = m.weight.shape[-1]
        y = F.conv2d(x_in, m.weight, stride=stride, padding=(k - 1) // 2)
        leaf = by_module[id(m)]
        gain = cls_gain if id(leaf) in cls_heads else 1.0
        scale = gain / y.std(dim=(0, 2, 3)).clamp(min=1e-6)            # per output channel
        m.weight.mul_(scale[:, None, None, None])
        leaf["w"] = (leaf["w"] * scale.numpy()).astype(np.float32)

    hooks = [m.register_forward_pre_hook(unit_spread) for _, m in pairs]
    try:
        with torch.no_grad():
            _forward_nchw(yolo, x)
    finally:
        for h in hooks:
            h.remove()
    return params


def save_yolo_npz(path: str, params: Dict[str, Any], scale: str, nc: int = NUM_CLASSES) -> None:
    """Write params in the JAX package's YOLO ``.npz`` format (its
    ``convert/yolo_torch.py::save_yolo_npz``): the flat tree and a
    ``__meta__`` scale and class count."""
    from ..utils.checkpoint import flatten_params
    flat = flatten_params(params)
    flat["__meta__/scale"] = np.asarray(scale)
    flat["__meta__/nc"] = np.asarray(nc)
    np.savez_compressed(path, **flat)


def _conv_leaves(tree):
    """The {"w", "b"} leaves of a params tree, in the order of its dicts."""
    if isinstance(tree, dict) and set(tree) == {"w", "b"}:
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _conv_leaves(v)
    else:
        for v in tree:
            yield from _conv_leaves(v)


def _conv_modules(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, Conv)]


# --------------------------------------------------------------------- ops
# x is NCHW (channels_last in memory) in the detector's dtype throughout

def conv_bn_silu(x: torch.Tensor, p: Conv, stride: int = 1, act: bool = True) -> torch.Tensor:
    """Conv (BN folded) + bias + SiLU: :meth:`Conv.forward`."""
    return p(x, stride, act)


def bottleneck(x: torch.Tensor, p, shortcut: bool) -> torch.Tensor:
    y = conv_bn_silu(x, p["cv1"])
    y = conv_bn_silu(y, p["cv2"])
    return x + y if shortcut else y


def c2f(x: torch.Tensor, p, n: int, shortcut: bool) -> torch.Tensor:
    y = conv_bn_silu(x, p["cv1"])
    c = y.shape[1] // 2
    parts = [y[:, :c], y[:, c:]]
    for i in range(n):
        parts.append(bottleneck(parts[-1], p["m"][i], shortcut))
    return conv_bn_silu(torch.cat(parts, 1), p["cv2"])


def sppf(x: torch.Tensor, p) -> torch.Tensor:
    y = conv_bn_silu(x, p["cv1"])
    outs = [y]
    for _ in range(3):
        outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
    return conv_bn_silu(torch.cat(outs, 1), p["cv2"])


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x (ultralytics nn.Upsample(scale_factor=2, mode='nearest'))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _forward_nchw(model: Yolo, x: torch.Tensor) -> List[torch.Tensor]:
    dps = model.spec.depths
    m = model.model
    y0 = conv_bn_silu(x, m["0"], stride=2)                    # P1
    y1 = conv_bn_silu(y0, m["1"], stride=2)                   # P2
    y2 = c2f(y1, m["2"], dps[0], True)
    y3 = conv_bn_silu(y2, m["3"], stride=2)                   # P3
    y4 = c2f(y3, m["4"], dps[1], True)
    y5 = conv_bn_silu(y4, m["5"], stride=2)                   # P4
    y6 = c2f(y5, m["6"], dps[1], True)
    y7 = conv_bn_silu(y6, m["7"], stride=2)                   # P5
    y8 = c2f(y7, m["8"], dps[3], True)
    y9 = sppf(y8, m["9"])

    y12 = c2f(torch.cat([upsample2x(y9), y6], 1), m["12"], dps[3], False)
    y15 = c2f(torch.cat([upsample2x(y12), y4], 1), m["15"], dps[3], False)   # P3 out
    y16 = conv_bn_silu(y15, m["16"], stride=2)
    y18 = c2f(torch.cat([y16, y12], 1), m["18"], dps[3], False)             # P4 out
    y19 = conv_bn_silu(y18, m["19"], stride=2)
    y21 = c2f(torch.cat([y19, y9], 1), m["21"], dps[3], False)              # P5 out

    det = m["22"]
    outs = []
    for li, feat in enumerate((y15, y18, y21)):
        box = feat
        for j in range(2):
            box = conv_bn_silu(box, det["cv2"][li][j])
        box = conv_bn_silu(box, det["cv2"][li][2], act=False)  # plain conv
        cls = feat
        for j in range(2):
            cls = conv_bn_silu(cls, det["cv3"][li][j])
        cls = conv_bn_silu(cls, det["cv3"][li][2], act=False)
        outs.append(torch.cat([box, cls], 1))
    return outs


@torch.no_grad()
def yolo_forward(model: Yolo, x: torch.Tensor) -> List[torch.Tensor]:
    """Backbone + neck + detect.  x: (B, H, W, 3) normalized [0, 1] NHWC, in
    the detector's dtype.  Returns per-level raw head outputs
    [(B, h_l, w_l, 4*REG_MAX + nc)], NHWC as in JAX.  float32 convolutions
    run in float32, deterministically (the module docstring)."""
    with float32_convolutions(x.dtype):
        outs = _forward_nchw(model, x.permute(0, 3, 1, 2))
    return [o.permute(0, 2, 3, 1) for o in outs]


@functools.lru_cache(maxsize=None)
def _anchors(H: int, W: int, device: torch.device) -> torch.Tensor:
    """(H*W, 2) anchor centres (x + 0.5, y + 0.5), made once per device."""
    cx = (torch.arange(W, dtype=torch.float32) + 0.5)[None, :].repeat(H, 1)
    cy = (torch.arange(H, dtype=torch.float32) + 0.5)[:, None].repeat(1, W)
    return torch.stack([cx.reshape(-1), cy.reshape(-1)], -1).to(device)


@functools.lru_cache(maxsize=None)
def _bins(device: torch.device) -> torch.Tensor:
    return torch.arange(REG_MAX, dtype=torch.float32).to(device)


def decode_detections(outs: Sequence[torch.Tensor], nc: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw NHWC head outputs -> (boxes (B, A, 4) xyxy in input px, scores
    (B, A, nc)), in float32.  DFL: softmax over REG_MAX bins -> expected
    distance per side, times stride, around the (x+0.5, y+0.5) anchors."""
    boxes_all, scores_all = [], []
    for feat, stride in zip(outs, STRIDES):
        B, H, W, C = feat.shape
        raw = feat.reshape(B, H * W, C).float()
        box_raw = raw[..., : 4 * REG_MAX].reshape(B, H * W, 4, REG_MAX)
        dist = torch.sum(torch.softmax(box_raw, -1) * _bins(feat.device), -1)
        anchors = _anchors(H, W, feat.device)[None]
        x1y1 = (anchors - dist[..., :2]) * stride
        x2y2 = (anchors + dist[..., 2:]) * stride
        boxes_all.append(torch.cat([x1y1, x2y2], -1))
        scores_all.append(torch.sigmoid(raw[..., 4 * REG_MAX:]))
    return torch.cat(boxes_all, 1), torch.cat(scores_all, 1)


# -------------------------------------------------------------- letterbox

def letterbox_geometry(h: int, w: int, imgsz: int, rect: bool = False,
                       stride: int = 32):
    """Ultralytics LetterBox math, host-side ints (``round`` is Python's,
    half to even).  rect=False: square imgsz x imgsz canvas, center pad.
    rect=True: the scaled size rounded up to the stride multiple.
    Returns (r, new_w, new_h, left, top, canvas_w, canvas_h)."""
    r = min(imgsz / h, imgsz / w)
    new_w, new_h = round(w * r), round(h * r)
    if rect:
        canvas_w = -(-new_w // stride) * stride
        canvas_h = -(-new_h // stride) * stride
    else:
        canvas_w = canvas_h = imgsz
    dw, dh = (canvas_w - new_w) / 2, (canvas_h - new_h) / 2
    top = int(round(dh - 0.1))
    left = int(round(dw - 0.1))
    return r, new_w, new_h, left, top, canvas_w, canvas_h


def _scale(n: int, new_n: int) -> float:
    """``n / new_n`` rounded to float32 once, as JAX rounds the Python
    double; a Python float of that value multiplies a float32 tensor
    exactly as the float32 constant does."""
    return float(np.float32(n / new_n))


def letterbox_sample_plain(frame: torch.Tensor, canvas_wh, r: float, new_w: int,
                           new_h: int, left: int, top: int) -> torch.Tensor:
    """Bilinear sample of the (H, W, 3) uint8 frame (or (S, H, W, 3) stack)
    into the canvas, 114 outside the resized image: (canvas_h, canvas_w, 3)
    (or (S, canvas_h, canvas_w, 3)) float32 in [0, 255].
    A literal transcription of JAX's ``letterbox_sample`` (cv2's half-pixel
    map, the x lerp then the y lerp, each ``a * (1 - f) + b * f``)."""
    cw, ch = (canvas_wh, canvas_wh) if isinstance(canvas_wh, int) else canvas_wh
    H, W = frame.shape[-3:-1]
    dev = frame.device
    xs = torch.arange(cw, dtype=torch.float32, device=dev)
    ys = torch.arange(ch, dtype=torch.float32, device=dev)
    src_x = (xs - left + 0.5) * _scale(W, new_w) - 0.5
    src_y = (ys - top + 0.5) * _scale(H, new_h) - 0.5
    in_x = (xs >= left) & (xs < left + new_w)
    in_y = (ys >= top) & (ys < top + new_h)
    sx = torch.clamp(src_x, 0.0, W - 1.0)
    sy = torch.clamp(src_y, 0.0, H - 1.0)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = (sx - x0)[None, :, None]
    fy = (sy - y0)[:, None, None]
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    xv = frame[..., x0, :].float() * (1 - fx) + frame[..., x1, :].float() * fx  # (.., H, cw, 3)
    out = xv[..., y0, :, :] * (1 - fy) + xv[..., y1, :, :] * fy          # (.., ch, cw, 3)
    mask = (in_y[:, None] & in_x[None, :])[..., None]
    return torch.where(mask, out, LETTERBOX_FILL)


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar tensor, made once per device: a divisor as a tensor,
    because CUDA divides by a Python scalar as a multiply by its
    reciprocal, which is not JAX's IEEE division."""
    return torch.tensor(value, dtype=torch.float32).to(device)


def letterbox_input_plain(frame: torch.Tensor, geom, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of D1: the letterboxed frame (or stack of S
    frames) divided by 255 and cast: (1 or S, 3, canvas_h, canvas_w) in
    ``dtype``, channels_last."""
    r, new_w, new_h, left, top, cw, ch = geom
    img = letterbox_sample_plain(frame, (cw, ch), r, new_w, new_h, left, top)
    x = (img / _const(255.0, frame.device)).to(dtype)
    return (x[None] if frame.dim() == 3 else x).permute(0, 3, 1, 2)


def letterbox_input(frame: torch.Tensor, geom, dtype=torch.float32) -> torch.Tensor:
    """D1: the (H, W, 3) uint8 frame, or an (S, H, W, 3) stack of frames of
    one size -> the detector's input (1 or S, 3, canvas_h, canvas_w) in
    ``dtype`` (float32 or bfloat16), channels_last: the letterbox, the
    divide by 255 and the cast in one launch.  A frame on the CPU takes
    :func:`letterbox_input_plain`."""
    if frame.device.type == "cpu":
        return letterbox_input_plain(frame, geom, dtype)
    dev = kernels.require_cuda(frame)
    if (frame.dtype != torch.uint8 or frame.dim() not in (3, 4) or frame.shape[-1] != 3
            or frame.numel() == 0):
        raise ValueError(f"frame must be (H, W, 3) or (S, H, W, 3) uint8, got "
                         f"{tuple(frame.shape)} {frame.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    r, new_w, new_h, left, top, cw, ch = geom
    if min(new_w, new_h, cw, ch) <= 0:
        raise ValueError(f"letterbox geometry {geom} is empty")
    frame = frame.contiguous()
    H, W = frame.shape[-3:-1]
    S = 1 if frame.dim() == 3 else frame.shape[0]
    out = torch.empty((S, ch, cw, 3), dtype=dtype, device=dev)
    kernels.call("letterbox", "evt_letterbox", dev, frame.data_ptr(), out.data_ptr(), S, H, W,
                 cw, ch, new_w, new_h, left, top, _scale(W, new_w), _scale(H, new_h),
                 int(dtype == torch.bfloat16))
    kernels.count_launch("letterbox")
    return out.permute(0, 3, 1, 2)


# -------------------------------------------------------------------- NMS

def nms_candidates(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
                   conf_threshold: float, max_det: int):
    """The score-sorted top-k candidates, k = min(max_det, A): (boxes (k, 4),
    scores (k,), classes (k,)), or per frame of a stack ((S, A, 4) boxes ->
    (S, k, 4), ...); scores not above ``conf_threshold`` become -1.  A
    stable descending sort along the last axis puts lower indices first
    among equal scores, as ``lax.top_k`` does (``torch.topk``'s tie order
    on CUDA is not specified)."""
    k = min(max_det, boxes.shape[-2])
    s = torch.where(scores > conf_threshold, scores, -1.0)
    idx = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]
    top_b = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    return top_b, torch.gather(s, -1, idx), torch.gather(class_ids, -1, idx)


def greedy_keep_plain(top_b: torch.Tensor, top_s: torch.Tensor, top_c: torch.Tensor,
                      iou_threshold: float, class_agnostic: bool = False) -> torch.Tensor:
    """(k,) bool: greedy NMS over score-sorted candidates, as JAX's Jacobi
    fixpoint (``nms_fixed``), with a host loop for its ``while_loop``."""
    k = top_b.shape[0]
    valid = top_s > 0
    nb = top_b if class_agnostic else top_b + top_c.float()[:, None] * CLASS_OFFSET
    x1, y1, x2, y2 = nb[:, 0], nb[:, 1], nb[:, 2], nb[:, 3]
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    overlap = iou > iou_threshold
    ar = torch.arange(k, device=top_b.device)
    ov_lower = overlap & (ar[:, None] < ar[None, :])          # j < i

    def sweep(keep):
        return valid & ~torch.any(ov_lower & keep[:, None], dim=0)

    keep, prev, it = sweep(valid), valid, 0
    while bool((keep != prev).any()) and it < k:
        keep, prev, it = sweep(keep), keep, it + 1
    return keep


def _compact(keep: torch.Tensor, top_b, top_s, top_c, max_det: int):
    """Kept rows first, the rest after, each in score order (JAX's
    ``argsort(~keep, stable=True)``), zero-padded to ``max_det`` rows."""
    k = top_b.shape[0]
    sel = torch.sort((~keep).to(torch.uint8), stable=True).indices
    pad = max(max_det - k, 0)
    out_b = F.pad(top_b[sel], (0, 0, 0, pad))
    out_s = F.pad(torch.where(keep, top_s, 0.0)[sel], (0, pad))
    out_c = F.pad(top_c[sel], (0, pad))
    out_v = F.pad(keep[sel], (0, pad))
    return out_b, out_s, out_c, out_v


def nms_fixed_plain(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor, *,
                    iou_threshold: float = 0.7, conf_threshold: float = 0.25,
                    max_det: int = 300, class_agnostic: bool = False):
    """JAX's ``nms_fixed`` in PyTorch: (A, 4) boxes, (A,) scores and int32
    classes -> (boxes (max_det, 4), scores (max_det,), classes (max_det,),
    valid (max_det,)), kept rows first in score order."""
    top_b, top_s, top_c = nms_candidates(boxes, scores, class_ids, conf_threshold, max_det)
    keep = greedy_keep_plain(top_b, top_s, top_c, iou_threshold, class_agnostic)
    return _compact(keep, top_b, top_s, top_c, max_det)


@functools.lru_cache(maxsize=None)
def _offsets(left: int, top: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([left, top, left, top], dtype=torch.float32).to(device)


def nms_packed_plain(top_b: torch.Tensor, top_s: torch.Tensor, top_c: torch.Tensor,
                     max_det: int, iou_threshold: float, left: int, top: int, r: float,
                     class_agnostic: bool = False) -> torch.Tensor:
    """Plain PyTorch version of D2: greedy NMS over score-sorted candidates
    (:func:`nms_candidates`), compaction, the un-letterbox ``(b - [left,
    top, left, top]) / r`` and the packing into (max_det, 7) float32 rows
    [x1, y1, x2, y2, conf, cls, valid]; for (S, k) candidates, frame by
    frame into (S, max_det, 7)."""
    if top_b.dim() == 3:
        return torch.stack([nms_packed_plain(b, s, c, max_det, iou_threshold, left, top, r,
                                             class_agnostic)
                            for b, s, c in zip(top_b, top_s, top_c)])
    keep = greedy_keep_plain(top_b, top_s, top_c, iou_threshold, class_agnostic)
    b, s, c, v = _compact(keep, top_b, top_s, top_c, max_det)
    dev = top_b.device
    b = (b - _offsets(left, top, dev)) / _const(float(np.float32(r)), dev)
    return torch.cat([b, s[:, None], c.float()[:, None], v.float()[:, None]], 1)


def nms_smem_bytes(k: int) -> int:
    """Shared memory of D2 for k candidates: offset boxes, areas, the
    bitmask of k x ceil(k / 32) words, the kept-before counts and flags."""
    return k * (16 + 4 + 4 + 1) + 4 * k * ((k + 31) // 32)


def nms_packed(top_b: torch.Tensor, top_s: torch.Tensor, top_c: torch.Tensor,
               max_det: int, iou_threshold: float, left: int, top: int, r: float,
               class_agnostic: bool = False) -> torch.Tensor:
    """D2: greedy NMS of the (k, 4) float32 boxes, (k,) float32 scores and
    (k,) int32 classes of :func:`nms_candidates` -> (max_det, 7) packed rows,
    un-letterboxed, in one launch (k <= max_det; rows past k are JAX's
    zero padding, un-letterboxed too); or of a stack's (S, k, ...)
    candidates -> (S, max_det, 7), one block per frame, in one launch.
    Candidates on the CPU take :func:`nms_packed_plain`.  Raises for a k
    whose bitmask does not fit in one block's shared memory
    (:func:`nms_smem_bytes` over :data:`SMEM_LIMIT`)."""
    if top_b.device.type == "cpu":
        return nms_packed_plain(top_b, top_s, top_c, max_det, iou_threshold, left, top, r,
                                class_agnostic)
    dev = kernels.require_cuda(top_b, top_s, top_c)
    lead = tuple(top_b.shape[:-2])
    k = top_b.shape[-2] if top_b.dim() >= 2 else 0
    if (top_b.dtype != torch.float32 or top_b.dim() not in (2, 3)
            or tuple(top_b.shape) != (*lead, k, 4)
            or top_s.dtype != torch.float32 or tuple(top_s.shape) != (*lead, k)
            or top_c.dtype != torch.int32 or tuple(top_c.shape) != (*lead, k)):
        raise ValueError("candidates must be ([S,] k, 4) float32 boxes, ([S,] k) float32 scores "
                         f"and ([S,] k) int32 classes, got {tuple(top_b.shape)} {top_b.dtype}, "
                         f"{tuple(top_s.shape)} {top_s.dtype}, {tuple(top_c.shape)} {top_c.dtype}")
    if not 0 < k <= max_det:
        raise ValueError(f"need 0 < k <= max_det, got k={k}, max_det={max_det}")
    if nms_smem_bytes(k) > SMEM_LIMIT:
        raise ValueError(f"k={k} candidates need {nms_smem_bytes(k)} bytes of shared memory, "
                         f"more than one block's {SMEM_LIMIT}")
    top_b, top_s, top_c = top_b.contiguous(), top_s.contiguous(), top_c.contiguous()
    S = lead[0] if lead else 1
    out = torch.empty((*lead, max_det, 7), dtype=torch.float32, device=dev)
    kernels.call("nms", "evt_nms", dev, top_b.data_ptr(), top_s.data_ptr(), top_c.data_ptr(),
                 out.data_ptr(), S, k, max_det, iou_threshold, int(not class_agnostic),
                 float(left), float(top), r)
    kernels.count_launch("nms")
    return out


# ----------------------------------------------------------- the detector

@functools.lru_cache(maxsize=None)
def _class_mask(classes: Tuple[int, ...], nc: int, device: torch.device) -> torch.Tensor:
    """(1, nc) bool: the classes that pass the class gate, made once per device."""
    sel = torch.zeros((1, nc), dtype=torch.bool)
    sel[0, list(classes)] = True
    return sel.to(device)


@torch.no_grad()
def detect_batch_core(model: Yolo, frames: torch.Tensor, geom, spec: YoloSpec, classes,
                      conf_t: float, iou_t: float, max_det: int, dtype,
                      plain: bool = False) -> torch.Tensor:
    """(S, H, W, 3) uint8 frames of one size -> letterbox (D1, one launch
    for the stack) -> YOLO at batch S -> DFL decode -> class gate -> each
    frame's score-sorted candidates -> NMS and un-letterbox (D2, one launch,
    a block per frame): (S, max_det, 7) float32 rows [x1, y1, x2, y2, conf,
    cls, valid], kept rows first per frame.  ``plain=True`` takes D1's and
    D2's plain versions on any device.  On the card nothing here makes the
    host wait."""
    r, new_w, new_h, left, top, cw, ch = geom
    x = (letterbox_input_plain if plain else letterbox_input)(frames, geom, dtype)
    boxes, scores = decode_detections(yolo_forward(model, x.permute(0, 2, 3, 1)), spec.nc)
    if classes is not None:
        scores = torch.where(_class_mask(tuple(classes), spec.nc, scores.device), scores, 0.0)
    conf, cls = torch.max(scores, -1)
    top_b, top_s, top_c = nms_candidates(boxes, conf, cls.to(torch.int32), conf_t, max_det)
    nms = nms_packed_plain if plain else nms_packed
    return nms(top_b, top_s, top_c, max_det, iou_t, left, top, r)


def detect_frame_core(model: Yolo, frame: torch.Tensor, geom, spec: YoloSpec, imgsz: int,
                      classes, conf_t: float, iou_t: float, max_det: int, dtype,
                      plain: bool = False) -> torch.Tensor:
    """One (H, W, 3) uint8 frame through :func:`detect_batch_core` as a
    stack of one: (max_det, 7) float32 rows on the frame's device."""
    return detect_batch_core(model, frame[None], geom, spec, classes, conf_t, iou_t, max_det,
                             dtype, plain=plain)[0]


def to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: a tensor moved as it is, a numpy array copied;
    to the card through pinned memory, so the host does not wait for the
    copy."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class YoloDetector:
    """Path-loading detector: frame (RGB uint8) -> (N, 6) rows
    [x1, y1, x2, y2, conf, cls].

    Takes the JAX package's ``.npz`` params (``convert/yolo_torch.py``'s
    ``save_yolo_npz``, with a ``__meta__`` scale and class count), or an
    ultralytics ``.pt`` (``convert/yolo_torch.py::load_ultralytics_checkpoint``,
    which needs the ultralytics package for a released file).  Runs on
    ``device``: CUDA unless the caller asks for the CPU.  On the card each
    program is a CUDA graph replay (``graphs``, shared with the pipelines
    that hold this detector); ``plain=True`` takes D1's and D2's plain
    versions, eagerly (for checks)."""

    def __init__(self, path: str, imgsz: int = 320,
                 classes: Optional[Sequence[int]] = None,
                 conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300, dtype=torch.float32,
                 rect: bool = False, device=None, plain: bool = False):
        from ..utils.checkpoint import load_params
        if not path.endswith((".npz", ".pt")):
            raise ValueError(f"unsupported YOLO checkpoint: {path}")
        self.device = kernels.resolve_device(device)
        if path.endswith(".pt"):
            from ..convert.yolo_torch import load_ultralytics_checkpoint
            tree, scale, nc = load_ultralytics_checkpoint(path)
        else:
            tree = load_params(path)
            meta = tree.pop("__meta__", None)
            scale = str(np.asarray(meta["scale"]).item()) if meta is not None else "n"
            nc = int(np.asarray(meta["nc"]).item()) if meta is not None else NUM_CLASSES
        self.spec = YoloSpec(scale=scale, nc=nc)
        self.model = yolo_params_from_jax(tree, self.spec, dtype, self.device)
        self.imgsz = int(imgsz)
        self.classes = None if classes is None else tuple(classes)
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.dtype = dtype
        self.rect = rect
        self.plain = plain
        from ..pipeline.graphs import GraphCache
        self.graphs = GraphCache()

    def on(self, device) -> "YoloDetector":
        """A replica on ``device`` (this detector where it is there
        already): the same settings, its weights copied there, its own
        graphs."""
        device = kernels.resolve_device(device)
        if device == self.device:
            return self
        from ..pipeline.graphs import GraphCache
        r = copy.copy(self)
        r.device, r.model, r.graphs = device, copy.deepcopy(self.model).to(device), GraphCache()
        return r

    @property
    def graphed(self) -> bool:
        """True where programs run as CUDA graph replays (the card, not
        ``plain``)."""
        return self.device.type == "cuda" and not self.plain

    def geometry(self, frame_hw):
        """The letterbox geometry of a frame of size ``frame_hw``."""
        return letterbox_geometry(*frame_hw, self.imgsz, rect=self.rect)

    def _run(self, name: str, frames: torch.Tensor, geom) -> torch.Tensor:
        """``detect_batch_core`` of a stack, or ``detect_frame_core`` of a
        frame, graphed on the card."""
        core = detect_frame_core if frames.dim() == 3 else detect_batch_core
        args = ((self.imgsz,) if frames.dim() == 3 else ())

        def program(f):
            return core(self.model, f, geom, self.spec, *args, self.classes, self.conf,
                        self.iou, self.max_det, self.dtype, plain=self.plain)

        if not self.graphed:
            return program(frames)
        return self.graphs.run((name, tuple(frames.shape), self.dtype), program, frames)

    def detect_async(self, img, frame_hw=None) -> torch.Tensor:
        """Queue detection of one frame without waiting: the packed
        (max_det, 7) rows on the device, for :meth:`unpack` after a fetch."""
        H, W = frame_hw if frame_hw is not None else img.shape[:2]
        return self._run("detect_frame", to_device(img, self.device), self.geometry((H, W)))

    def detect_batch_async(self, frames) -> torch.Tensor:
        """Queue detection of an (S, H, W, 3) stack of frames of one size
        without waiting: the packed (S, max_det, 7) rows on the device, for
        :meth:`unpack_batch` after a fetch."""
        frames = to_device(frames, self.device)
        return self._run("detect_batch", frames, self.geometry(tuple(frames.shape[1:3])))

    @staticmethod
    def unpack_batch(packed: np.ndarray, frame_hw) -> list:
        """(S, max_det, 7) packed (fetched) -> list of S (N_s, 6) rows,
        frame-clipped."""
        return [YoloDetector.unpack(p, frame_hw) for p in packed]

    def detect_batch(self, frames) -> list:
        """frames: (S, H, W, 3) uint8 stack (numpy or tensor) -> list of S
        (N_s, 6) [x1, y1, x2, y2, conf, cls] numpy arrays; one fetch."""
        H, W = frames.shape[1:3]
        return self.unpack_batch(self.detect_batch_async(frames).cpu().numpy(), (H, W))

    @staticmethod
    def unpack(packed: np.ndarray, frame_hw) -> np.ndarray:
        """(max_det, 7) packed (fetched) -> (N, 6) rows, frame-clipped."""
        H, W = frame_hw
        keep = packed[:, 6] > 0
        out = np.array(packed[keep])
        out[:, :4] = np.clip(out[:, :4], 0, [W, H, W, H])
        return out[:, :6]

    def __call__(self, img, frame_hw=None) -> np.ndarray:
        """img: (H, W, 3) RGB uint8 (numpy or tensor) -> (N, 6)
        [x1, y1, x2, y2, conf, cls] numpy."""
        H, W = frame_hw if frame_hw is not None else img.shape[:2]
        packed = self.detect_async(img, (H, W)).cpu().numpy()
        return self.unpack(packed, (H, W))
