"""Plain reference of the ViTPose pose step and its training step.

Plain PyTorch in float32 (TF32 off), from the published description
(ViTPose, arXiv:2204.12484; easy_ViTPose's top-down pipeline and mmpose's
UDP decode), over a state dict keyed by the reference checkpoints' names.
It imports nothing of the port and nothing of JAX, and works out from the
weights and inputs it is handed whatever the port derives (the integer
weights, the crops, the targets, the optimizer's coded moments).

Serving at W8A8 (``qbits=8``): each linear's weight is quantized per output
channel and its input per row, symmetric, ``s = amax / (2^(b-1) - 1)``,
``q = round-half-even(x / s)``; integer products summed exactly (float64),
then scaled.  ``qbits=4`` is the control: the same at int4.  Training's
control rounds the operands of every product and convolution to fp8
(e4m3, per-tensor scale), where AMP runs them in bf16.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP_W, CROP_H = 192, 256
PAD_BBOX = 10
BN_EPS = 1e-5
UDP_KERNEL = 11


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for float32 products and convolutions inside the block,
    the caller's flags restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ crops
def crop_geometry(boxes: torch.Tensor, H: int, W: int) -> Dict[str, torch.Tensor]:
    """easy_ViTPose's crop: the box rounded half to even, inflated by 10 px
    and clipped to the frame, padded with zeros to a 3:4 aspect (the pad
    split ``pad // 2``)."""
    b = torch.round(boxes.float()).long()
    x1 = (b[:, 0] - PAD_BBOX).clamp(0, W)
    y1 = (b[:, 1] - PAD_BBOX).clamp(0, H)
    x2 = (b[:, 2] + PAD_BBOX).clamp(0, W)
    y2 = (b[:, 3] + PAD_BBOX).clamp(0, H)
    wc = (x2 - x1).clamp(min=1)
    hc = (y2 - y1).clamp(min=1)
    horiz = 4 * wc < 3 * hc
    wp = torch.maximum(torch.where(horiz, (3 * hc) // 4, wc), wc)
    hp = torch.maximum(torch.where(horiz, hc, (4 * wc) // 3), hc)
    left = torch.where(horiz, (wp - wc) // 2, torch.zeros_like(wc))
    top = torch.where(horiz, torch.zeros_like(wc), (hp - hc) // 2)
    return {"x1": x1, "y1": y1, "wc": wc, "hc": hc, "wp": wp, "hp": hp,
            "left": left, "top": top}


def _axis(size_p, lo, size, origin, n_out: int, n_frame: int):
    """cv2's half-pixel bilinear map over one axis of the padded crop:
    the two taps' frame indices, whether each lies inside the crop, and
    tap 1's weight."""
    sp = size_p.double()[:, None]
    o = torch.arange(n_out, dtype=torch.float64, device=size_p.device)[None]
    s = ((o + 0.5) * sp / n_out - 0.5).clamp(min=0.0)
    s = torch.minimum(s, sp - 1.0)
    i0 = torch.floor(s).long()
    f = (s - i0).float()
    i1 = torch.minimum(i0 + 1, size_p[:, None] - 1)
    out = []
    for i in (i0, i1):
        inside = (i >= lo[:, None]) & (i < (lo + size)[:, None])
        out.append(((i - lo[:, None] + origin[:, None]).clamp(0, n_frame - 1), inside))
    return out[0], out[1], f


def crops(frame: torch.Tensor, geo) -> torch.Tensor:
    """(M, 256, 192, 3) float32 normalized crops of one (H, W, 3) frame."""
    H, W = frame.shape[:2]
    (gx0, in_x0), (gx1, in_x1), fx = _axis(geo["wp"], geo["left"], geo["wc"], geo["x1"],
                                           CROP_W, W)
    (gy0, in_y0), (gy1, in_y1), fy = _axis(geo["hp"], geo["top"], geo["hc"], geo["y1"],
                                           CROP_H, H)
    img = frame.float()

    def row(gy, iny):
        c0 = img[gy[:, :, None], gx0[:, None, :]] * in_x0[:, None, :, None]
        c1 = img[gy[:, :, None], gx1[:, None, :]] * in_x1[:, None, :, None]
        r = c0 * (1 - fx)[:, None, :, None] + c1 * fx[:, None, :, None]
        return r * iny[:, :, None, None]

    out = row(gy0, in_y0) * (1 - fy)[:, :, None, None] + row(gy1, in_y1) * fy[:, :, None, None]
    mean = torch.tensor(IMAGENET_MEAN, device=frame.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=frame.device) * 255.0
    return (out - mean) / std


# ------------------------------------------------------------------ model
def fake_quant_rows(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization: (integer values as float64, scales)."""
    top = float(2 ** (bits - 1) - 1)
    amax = x.abs().amax(-1, keepdim=True).double()
    s = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return torch.clamp(torch.round(x.double() / s), -top, top), s


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with a per-tensor scale (its largest magnitude
    at 448), back in float32; the straight-through gradient."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x).detach()


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 (per-tensor scale,
    its largest magnitude at 57344) on its way back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        s = 57344.0 / g.abs().amax().clamp(min=1e-30)
        return (g * s).to(torch.float8_e5m2).float() / s


class Linears:
    """How the reference forms ``x @ w.T + b``: float32, W8A8 or W4A4
    (``qbits``), or in fp8 (``fp8``: the hybrid recipe, the operands of
    every product and convolution in e4m3 and the gradients that reach
    them in e5m2)."""

    def __init__(self, qbits: Optional[int] = None, fp8: bool = False):
        self.qbits, self.fp8 = qbits, fp8
        self._wq = {}

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product or convolution, rounded as the control
        rounds it."""
        return fp8_round(x) if self.fp8 else x

    def o(self, y: torch.Tensor) -> torch.Tensor:
        """A product's or convolution's result, whose gradient the control
        rounds."""
        return _GradE5M2.apply(y) if self.fp8 else y

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.qbits is None:
            if self.fp8:
                x, w = fp8_round(x), fp8_round(w)
            return self.o(torch.matmul(x, w.t())) + b
        key = w.data_ptr()
        if key not in self._wq:
            self._wq[key] = fake_quant_rows(w, self.qbits)
        wq, sw = self._wq[key]
        shape = x.shape
        xq, sx = fake_quant_rows(x.reshape(-1, shape[-1]), self.qbits)
        y = (torch.matmul(xq, wq.t()) * sx * sw.reshape(1, -1)).float() + b
        return y.reshape(*shape[:-1], -1)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def block(x, p, pre: str, heads: int, eps: float, lin: Linears, keep=None):
    B, N, D = x.shape
    hd = D // heads
    h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"], eps)
    qkv = lin(h, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"])
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    a = torch.softmax(lin.o(torch.matmul(lin.r(q * hd ** -0.5), lin.r(k).transpose(-1, -2))), -1)
    o = lin.o(torch.matmul(lin.r(a), lin.r(v))).transpose(1, 2).reshape(B, N, D)
    o = lin(o, p[pre + "attn.proj.weight"], p[pre + "attn.proj.bias"])
    x = x + (o if keep is None else o * keep)
    h = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"], eps)
    m = F.gelu(lin(h, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"]))
    m = lin(m, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"])
    return x + (m if keep is None else m * keep)


def backbone(p, x: torch.Tensor, cfg, lin: Linears, keep=None) -> torch.Tensor:
    """(B, 256, 192, 3) crops -> (B, D, 16, 12) features.  The patch conv
    keeps the reference's padding 2 and its crop to whole patches; the
    position embedding is added as ``pe[:, 1:] + pe[:, :1]``; ``keep``
    is the (depth, B, 1, 1) stochastic-depth mask of training."""
    P, pad = cfg["patch_size"], cfg["patch_padding"]
    t = lin.o(F.conv2d(lin.r(x.permute(0, 3, 1, 2)), lin.r(p["backbone.patch_embed.proj.weight"]),
                       stride=P, padding=pad)) + p["backbone.patch_embed.proj.bias"][:, None, None]
    B, D, Hp, Wp = t.shape
    t = t.flatten(2).transpose(1, 2)
    pe = p["backbone.pos_embed"]
    t = t + pe[:, 1:] + pe[:, :1]
    for i in range(cfg["depth"]):
        kp = None if keep is None else keep[i].reshape(B, 1, 1)
        t = block(t, p, f"backbone.blocks.{i}.", cfg["num_heads"], cfg["layer_norm_eps"], lin, kp)
    t = layer_norm(t, p["backbone.last_norm.weight"], p["backbone.last_norm.bias"],
                   cfg["layer_norm_eps"])
    return t.transpose(1, 2).reshape(B, D, Hp, Wp)


def head(p, f: torch.Tensor, cfg, train_bn: Optional[dict] = None,
         lin: Optional[Linears] = None) -> torch.Tensor:
    """Two (4x4, stride 2) deconvolutions with BN and ReLU, a 1x1 conv.
    ``train_bn`` (a dict) takes the BN's batch statistics and receives the
    new running statistics, momentum 0.1, unbiased variance."""
    lin = lin or Linears()
    for i in range(len(cfg["deconv_filters"])):
        dc, bn = f"keypoint_head.deconv_layers.{3 * i}", f"keypoint_head.deconv_layers.{3 * i + 1}"
        f = lin.o(F.conv_transpose2d(lin.r(f), lin.r(p[dc + ".weight"]), stride=2, padding=1))
        if train_bn is None:
            mean, var = p[bn + ".running_mean"], p[bn + ".running_var"]
        else:
            mean = f.mean((0, 2, 3))
            var = f.var((0, 2, 3), unbiased=False)
            n = f.shape[0] * f.shape[2] * f.shape[3]
            with torch.no_grad():
                train_bn[bn + ".running_mean"] = 0.9 * p[bn + ".running_mean"] + 0.1 * mean
                train_bn[bn + ".running_var"] = (0.9 * p[bn + ".running_var"]
                                                 + 0.1 * var * n / (n - 1))
        f = (f - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
        f = torch.relu(f * p[bn + ".weight"][:, None, None] + p[bn + ".bias"][:, None, None])
    return lin.o(F.conv2d(lin.r(f), lin.r(p["keypoint_head.final_layer.weight"]))) \
        + p["keypoint_head.final_layer.bias"][:, None, None]


# ----------------------------------------------------------------- decode
def gaussian_taps(kernel: int) -> torch.Tensor:
    """cv2.getGaussianKernel(kernel, 0)."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    x = torch.arange(kernel, dtype=torch.float64) - (kernel - 1) * 0.5
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return (g / g.sum()).float()


def udp_decode(heat: torch.Tensor, geo) -> torch.Tensor:
    """mmpose's UDP decode of (M, K, 64, 48) maps, un-cropped into the frame:
    (M, K, 3) rows (y, x, score).  The argmax of the raw map, then one
    Newton step on log(clip(blur(map), 0.001, 50)) (11-tap Gaussian,
    reflect-101), edge-padded by one and read as one flat array over the
    whole batch (mmpose's ``post_dark_udp``: a border peak reads the next
    map), then ``x * size / (W - 1) + center - size / 2``."""
    M, K, H, W = heat.shape
    flat = heat.reshape(M, K, H * W)
    idx = flat.argmax(-1)
    score = flat.amax(-1)
    px, py = (idx % W).float(), (idx // W).float()
    px = torch.where(score > 0, px, torch.full_like(px, -1.0))
    py = torch.where(score > 0, py, torch.full_like(py, -1.0))
    r = UDP_KERNEL // 2
    g = gaussian_taps(UDP_KERNEL).to(heat.device)
    hp = F.pad(heat.reshape(M * K, 1, H, W), (r, r, r, r), mode="reflect")
    hb = F.conv2d(F.conv2d(hp, g.reshape(1, 1, 1, -1)), g.reshape(1, 1, -1, 1))
    hm = torch.log(hb.clamp(0.001, 50.0))
    hm = F.pad(hm, (1, 1, 1, 1), mode="replicate").reshape(-1)
    base = (px.long() + 1) + (py.long() + 1) * (W + 2) + \
        (H + 2) * (W + 2) * torch.arange(M * K, device=heat.device).reshape(M, K)

    def at(o):
        return hm[(base + o) % hm.numel()]

    i0, ix1, iy1, ix1y1 = at(0), at(1), at(W + 2), at(W + 3)
    ix1_y1_, ix1_, iy1_ = at(-(W + 3)), at(-1), at(-(W + 2))
    dx, dy = 0.5 * (ix1 - ix1_), 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2 * i0 + ix1_ + 1.1920929e-07
    dyy = iy1 - 2 * i0 + iy1_ + 1.1920929e-07
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2 * i0 - ix1_ - iy1_ + ix1_y1_)
    det = dxx * dyy - dxy * dxy
    x = px - (dyy * dx - dxy * dy) / det
    y = py - (dxx * dy - dxy * dx) / det
    sx, sy = geo["wp"].float()[:, None], geo["hp"].float()[:, None]
    x = x * sx / (W - 1) + (geo["wp"] // 2).float()[:, None] - sx / 2 \
        + (geo["x1"] - geo["left"]).float()[:, None]
    y = y * sy / (H - 1) + (geo["hp"] // 2).float()[:, None] - sy / 2 \
        + (geo["y1"] - geo["top"]).float()[:, None]
    return torch.stack([y, x, score], -1)


@torch.no_grad()
def pose(p, frame: torch.Tensor, boxes: torch.Tensor, cfg, qbits: Optional[int],
         rows: int = 16):
    """The pose step's reference on one frame: (heatmaps (M, K, 64, 48),
    keypoints (M, K, 3), geometry), in blocks of ``rows`` crops."""
    geo = crop_geometry(boxes, *frame.shape[:2])
    lin = Linears(qbits)
    heat = []
    with float32_matmuls():
        for i in range(0, boxes.shape[0], rows):
            g = {k: v[i:i + rows] for k, v in geo.items()}
            heat.append(head(p, backbone(p, crops(frame, g), cfg, lin), cfg))
    heat = torch.cat(heat)
    return heat, udp_decode(heat, geo), geo


# --------------------------------------------------------------- training
Q8_BLOCK = 2048


def q8_levels(r: torch.Tensor, levels: int) -> torch.Tensor:
    """The blockwise-int8 moment code of magnitudes ``r = |x| / absmax``:
    ``levels`` steps on a geometric map from 1e-6 to 1 (0 below 1e-6)."""
    ln_eps = math.log(1e-6)
    t = torch.log(r.clamp_min(1e-30)) / ln_eps
    idx = (1.0 + torch.round((1.0 - t) * (levels - 1))).clamp(1.0, float(levels))
    return torch.where(r < 1e-6, torch.zeros_like(idx), idx)


def q8_values(idx: torch.Tensor, levels: int) -> torch.Tensor:
    ln_eps = math.log(1e-6)
    return torch.where(idx < 0.5, torch.zeros_like(idx),
                       torch.exp(ln_eps * (1.0 - (idx - 1.0) / (levels - 1))))


def q8_round(x: torch.Tensor, levels: int) -> torch.Tensor:
    """``x`` through the code and back: blocks of 2048 of the flat leaf,
    each scaled by its largest magnitude."""
    n = x.numel()
    nb = -(-n // Q8_BLOCK)
    xf = F.pad(x.reshape(-1), (0, nb * Q8_BLOCK - n)).reshape(nb, Q8_BLOCK)
    amax = xf.abs().amax(1, keepdim=True)
    mag = q8_values(q8_levels(xf.abs() / amax.clamp_min(1e-30), levels), levels) * amax
    return (torch.sign(xf) * mag).reshape(-1)[:n].reshape(x.shape)


def q8_decode(codes: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    """A leaf's first moment read back from its signed codes (127 levels)
    and its float32 scale per block."""
    c = codes.reshape(-1, Q8_BLOCK).float()
    x = torch.sign(c) * q8_values(c.abs(), 127) * scales.reshape(-1, 1)
    return x.reshape(-1)[:math.prod(shape)].reshape(shape)


def render_targets(joints: torch.Tensor, vis: torch.Tensor, sigma: float = 2.0,
                   hw: Tuple[int, int] = (64, 48), crop_hw: Tuple[int, int] = (256, 192)):
    """The reference's Gaussian targets of (B, K, 2) joints in crop pixels:
    the joint's cell ``trunc(xy / stride + 0.5)``, a 2*3*sigma+1 window, 0
    weight for a joint whose window is off the map or that is not visible."""
    Hh, Wh = hw
    stride = torch.tensor([crop_hw[1] / Wh, crop_hw[0] / Hh], device=joints.device)
    mu = torch.trunc(joints / stride + 0.5)
    ul = torch.trunc(mu - 3 * sigma)
    br = torch.trunc(mu + 3 * sigma + 1)
    w = vis[..., 0].float()
    off = (ul[..., 0] >= Wh) | (ul[..., 1] >= Hh) | (br[..., 0] < 0) | (br[..., 1] < 0)
    w = torch.where(off, torch.zeros_like(w), w)
    xs = torch.arange(Wh, device=joints.device).float()[None, None, None, :]
    ys = torch.arange(Hh, device=joints.device).float()[None, None, :, None]
    cx, cy = mu[..., 0][..., None, None], mu[..., 1][..., None, None]
    g = torch.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma ** 2))
    inside = ((xs >= ul[..., 0][..., None, None]) & (xs < br[..., 0][..., None, None])
              & (ys >= ul[..., 1][..., None, None]) & (ys < br[..., 1][..., None, None]))
    return torch.where(inside & (w[..., None, None] > 0.5), g, torch.zeros_like(g)), w[..., None]


def train_forward_loss(p, images_u8, joints, vis, cfg, keep, lin: Linears, bn_out: dict):
    """The finetune step's loss: images normalized, targets rendered, the
    training forward (stochastic depth from ``keep``, the head's BN on the
    batch), JointsMSELoss ``mean(((pred - target) * w)^2)``."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    x = (images_u8.float() / 255.0 - mean) / std
    target, w = render_targets(joints, vis, cfg["training"]["sigma"])
    heat = head(p, backbone(p, x, cfg, lin, keep), cfg, train_bn=bn_out, lin=lin)
    B, K = heat.shape[:2]
    d = (heat - target).reshape(B, K, -1) * w
    return (d * d).mean()


def adam_q8_step(params: dict, grads: dict, mu: dict, nu: dict, t: int, lr: float,
                 clip: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Global-norm clip, then Adam on every leaf with both moments kept as
    blockwise codes (the first signed at 127 levels, the second as
    sqrt(nu) unsigned at 255); updates ``params``, ``mu``, ``nu`` in place.
    Returns the clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    clipped = {}
    for k, p in params.items():
        g = grads[k] * scale
        clipped[k] = g
        m = b1 * mu[k] + (1 - b1) * g
        v = b2 * nu[k] * nu[k] + (1 - b2) * g * g
        p -= lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        mu[k] = q8_round(m, 127)
        nu[k] = q8_round(torch.sqrt(v), 255)
    return clipped


BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def train_steps(p0: Dict[str, torch.Tensor], batches, masks, cfg, steps: int,
                fp8: bool = False) -> dict:
    """The finetune recipe's first ``steps`` steps from ``p0`` on
    ``batches[t]`` with stochastic-depth masks ``masks[t]``: AMP's
    arithmetic in float32 (``fp8``: the control's e4m3 operands), Adam at
    ``lr`` with global-norm clip and int8 moments.  -> the losses, the
    first moment after one step, read back from its codes (``mu1``), the
    norms by leaf of the first gradient (``grad_raw``) and the parameters
    after the last step (``p3``)."""
    tc = cfg["training"]
    leaves = [k for k in p0 if k.rsplit(".", 1)[-1] not in BN_STATS]
    params = {k: p0[k].detach().clone() for k in leaves}
    stats = {k: v.detach().clone() for k, v in p0.items() if k not in params}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    lin = Linears(None, fp8=fp8)
    out = {"losses": []}
    with float32_matmuls():
        for t in range(steps):
            live = {k: v.requires_grad_(True) for k, v in params.items()}
            bn = {}
            loss = train_forward_loss({**live, **stats}, batches["images_u8"][t],
                                      batches["joints"][t], batches["joints_vis"][t], cfg,
                                      masks[t], lin, bn)
            grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
            out["losses"].append(float(loss.detach()))
            del loss
            params = {k: v.detach() for k, v in live.items()}
            stats.update(bn)
            with torch.no_grad():
                adam_q8_step(params, grads, mu, nu, t + 1, tc["lr"], tc["max_grad_norm"])
            if t == 0:
                out["mu1"] = dict(mu)
                out["grad_raw"] = {k: float(v.norm()) for k, v in grads.items()}
            del grads
    out["p3"] = params
    return out
