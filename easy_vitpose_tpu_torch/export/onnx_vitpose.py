"""ViTPose -> ONNX graph (dynamic batch axis).

Port of ``easy_vitpose_tpu/export/onnx_vitpose.py``, the ONNX twin of the
reference's export path (reference export.py:50-60: ``torch.onnx.export(...,
dynamic_axes={'input': {0: 'batch_size'}, ...})``).  Input/output names and
the NCHW (B, 3, 256, 192) -> (B, K, 64, 48) contract match the reference
artifact, so downstream ONNX consumers see the same tensor interface.

The port's entry point takes the port's ``ViTPose``: its float32 weights
go through ``convert/from_jax.py::state_dict_to_jax`` (which moves elements
only, bit for bit) into the JAX package's params layout, and
:func:`params_to_onnx` serializes that tree exactly as the JAX package
does, initializer for initializer and node for node, so the bytes of the
two exports of the same weights are equal.  ``torch.onnx.export`` is not
used: neither machine has the onnx package.

Graph semantics are the forward's at f32: patch conv (k16 s16 pad2 quirk)
-> +(pos[1:]+pos[:1]) -> depth x pre-LN blocks (LayerNormalization /
fused-QKV attention / exact-erf GELU MLP) -> final LN -> 2x (ConvTranspose
k4 s2 p1 + BatchNorm + ReLU) -> 1x1 conv.  Opset 17 (LayerNormalization is
native; GELU is decomposed via Erf so no opset-20 dependency).  The exported
bytes are checked by the numpy interpreter (``onnx_ref.py``) against the
port's forward (tests/test_torch_export.py, chip_smoke.py).
"""
from __future__ import annotations

from typing import Any, List, Mapping

import numpy as np

from ..configs import ModelConfig
from ..convert.from_jax import (conv_weight_to_torch, deconv_weight_to_torch,
                                patch_weight_to_torch)
from . import onnx_proto as P


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def check_exportable(cfg: ModelConfig) -> None:
    """Raise for the configs the ONNX graph does not cover: a hybrid stem,
    an upsample head, deconv stages with k != 4."""
    bb, hd = cfg.backbone, cfg.head
    if bb.stem_channels:
        raise NotImplementedError("hybrid-stem configs have no ONNX export")
    if hd.upsample:
        raise NotImplementedError("upsample-head configs have no ONNX export")
    if any(k != 4 for k in hd.deconv_kernels):
        raise NotImplementedError("only k=4 deconv stages are exported")


def vitpose_to_onnx(model, *, batch_dim: str = "batch_size") -> bytes:
    """Serialize a ``ViTPose`` with float weights (read as float32; not an
    int8 serving copy) as an ONNX ModelProto (bytes).  Covers the shipped
    configs (plain PatchEmbed, deconv head); others raise before any
    weight is read."""
    from ..convert.from_jax import state_dict_to_jax
    cfg = model.cfg
    check_exportable(cfg)
    return params_to_onnx(state_dict_to_jax(model.state_dict(), cfg), cfg, batch_dim=batch_dim)


def params_to_onnx(params: Mapping[str, Any], cfg: ModelConfig,
                   *, batch_dim: str = "batch_size") -> bytes:
    """The JAX package's serializer (``vitpose_to_onnx`` there) over a params
    tree in its layout."""
    check_exportable(cfg)
    bb, hd = cfg.backbone, cfg.head
    D, heads, depth = bb.embed_dim, bb.num_heads, bb.depth
    dh = D // heads
    Ph, Pw = bb.patch_shape
    N = Ph * Pw
    Cp, pad = bb.patch_size, bb.patch_padding
    K = hd.num_keypoints

    bbp, head = params["backbone"], params["head"]
    init: List[bytes] = []
    nodes: List[bytes] = []

    def add_init(name: str, arr: np.ndarray) -> str:
        init.append(P.tensor(name, arr))
        return name

    def add(op: str, inputs, outputs, **attrs):
        nodes.append(P.node(op, inputs, outputs,
                            name=f"{op}_{len(nodes)}", **attrs))

    def shape_const(name: str, dims) -> str:
        return add_init(name, np.asarray(dims, np.int64))

    # --- patch embedding: Conv k16 s16 pads=2 (the reference padding quirk,
    # reference vit.py:222), then (B, D, Ph, Pw) -> (B, N, D) tokens ---
    add_init("patch.w", patch_weight_to_torch(bbp["patch_w"], Cp,
                                              bb.in_chans, D))
    add_init("patch.b", _f32(bbp["patch_b"]))
    add("Conv", ["input", "patch.w", "patch.b"], ["patch.out"],
        strides=[Cp, Cp], pads=[pad, pad, pad, pad],
        kernel_shape=[Cp, Cp])
    shape_const("shape.tok2d", [0, D, N])
    add("Reshape", ["patch.out", "shape.tok2d"], ["tok.flat"])
    add("Transpose", ["tok.flat"], ["tok.bnd"], perm=[0, 2, 1])

    # pos-embed applied as pos[:, 1:] + pos[:, :1] (reference vit.py:382),
    # pre-folded into one (1, N, D) constant
    pe = _f32(bbp["pos_embed"])
    add_init("pos", pe[:, 1:] + pe[:, :1])
    add("Add", ["tok.bnd", "pos"], ["x0"])

    # reused reshape shapes / scalars
    shape_const("shape.heads", [0, N, heads, dh])
    shape_const("shape.merge", [0, N, D])
    add_init("attn.scale", np.asarray(dh ** -0.5, np.float32))
    add_init("c.sqrt2", np.asarray(np.sqrt(2.0), np.float32))
    add_init("c.one", np.asarray(1.0, np.float32))
    add_init("c.half", np.asarray(0.5, np.float32))

    blocks = bbp["blocks"]

    def layer(tree, i):
        return {k: (layer(v, i) if isinstance(v, dict) else _f32(v[i]))
                for k, v in tree.items()}

    x = "x0"
    for i in range(depth):
        b = layer(blocks, i)
        pfx = f"blk{i}."

        def w_(name: str, arr: np.ndarray) -> str:
            return add_init(pfx + name, arr)

        # --- attention (reference vit.py:143-180 semantics) ---
        w_("ln1.s", b["ln1_s"])
        w_("ln1.b", b["ln1_b"])
        add("LayerNormalization", [x, pfx + "ln1.s", pfx + "ln1.b"],
            [pfx + "ln1"], axis=-1, epsilon=bb.layer_norm_eps)
        w_("qkv.w", b["qkv_w"])                      # (D, 3D) — MatMul layout
        w_("qkv.b", b["qkv_b"])
        add("MatMul", [pfx + "ln1", pfx + "qkv.w"], [pfx + "qkv.mm"])
        add("Add", [pfx + "qkv.mm", pfx + "qkv.b"], [pfx + "qkv"])
        add("Split", [pfx + "qkv"],
            [pfx + "q", pfx + "k", pfx + "v"], axis=2)
        for t in ("q", "k", "v"):
            add("Reshape", [pfx + t, "shape.heads"], [pfx + t + ".4d"])
            add("Transpose", [pfx + t + ".4d"], [pfx + t + ".h"],
                perm=[0, 2, 1, 3])                   # (B, h, N, dh)
        add("Mul", [pfx + "q.h", "attn.scale"], [pfx + "q.s"])
        add("Transpose", [pfx + "k.h"], [pfx + "k.t"], perm=[0, 1, 3, 2])
        add("MatMul", [pfx + "q.s", pfx + "k.t"], [pfx + "logits"])
        add("Softmax", [pfx + "logits"], [pfx + "probs"], axis=-1)
        add("MatMul", [pfx + "probs", pfx + "v.h"], [pfx + "ctx"])
        add("Transpose", [pfx + "ctx"], [pfx + "ctx.t"], perm=[0, 2, 1, 3])
        add("Reshape", [pfx + "ctx.t", "shape.merge"], [pfx + "ctx.2d"])
        w_("proj.w", b["proj_w"])
        w_("proj.b", b["proj_b"])
        add("MatMul", [pfx + "ctx.2d", pfx + "proj.w"], [pfx + "proj.mm"])
        add("Add", [pfx + "proj.mm", pfx + "proj.b"], [pfx + "attn"])
        add("Add", [x, pfx + "attn"], [pfx + "x1"])

        # --- MLP with exact-erf GELU (torch nn.GELU default) ---
        w_("ln2.s", b["ln2_s"])
        w_("ln2.b", b["ln2_b"])
        add("LayerNormalization", [pfx + "x1", pfx + "ln2.s", pfx + "ln2.b"],
            [pfx + "ln2"], axis=-1, epsilon=bb.layer_norm_eps)
        w_("fc1.w", b["mlp"]["fc1_w"])
        w_("fc1.b", b["mlp"]["fc1_b"])
        add("MatMul", [pfx + "ln2", pfx + "fc1.w"], [pfx + "fc1.mm"])
        add("Add", [pfx + "fc1.mm", pfx + "fc1.b"], [pfx + "h"])
        add("Div", [pfx + "h", "c.sqrt2"], [pfx + "h.div"])
        add("Erf", [pfx + "h.div"], [pfx + "h.erf"])
        add("Add", [pfx + "h.erf", "c.one"], [pfx + "h.erf1"])
        add("Mul", [pfx + "h", pfx + "h.erf1"], [pfx + "h.g2"])
        add("Mul", [pfx + "h.g2", "c.half"], [pfx + "gelu"])
        w_("fc2.w", b["mlp"]["fc2_w"])
        w_("fc2.b", b["mlp"]["fc2_b"])
        add("MatMul", [pfx + "gelu", pfx + "fc2.w"], [pfx + "fc2.mm"])
        add("Add", [pfx + "fc2.mm", pfx + "fc2.b"], [pfx + "mlp"])
        add("Add", [pfx + "x1", pfx + "mlp"], [pfx + "out"])
        x = pfx + "out"

    # --- final LN, tokens -> NCHW feature map ---
    add_init("ln.s", _f32(bbp["ln_s"]))
    add_init("ln.b", _f32(bbp["ln_b"]))
    add("LayerNormalization", [x, "ln.s", "ln.b"], ["feat.ln"],
        axis=-1, epsilon=bb.layer_norm_eps)
    add("Transpose", ["feat.ln"], ["feat.t"], perm=[0, 2, 1])
    shape_const("shape.fmap", [0, D, Ph, Pw])
    add("Reshape", ["feat.t", "shape.fmap"], ["feat"])

    # --- head: (ConvTranspose k4 s2 p1 + BN + ReLU) * n + 1x1 conv ---
    # the params layout stores deconv weights pre-flipped (kh, kw, Cin,
    # Cout); ONNX ConvTranspose wants the torch IOHW layout, so undo the
    # flip (convert/from_jax.py::deconv_weight_to_torch).
    x = "feat"
    for i, (dc, bn) in enumerate(zip(head["deconv"], head["bn_state"])):
        add_init(f"dc{i}.w", deconv_weight_to_torch(dc["w"]))
        add("ConvTranspose", [x, f"dc{i}.w"], [f"dc{i}.out"],
            strides=[2, 2], pads=[1, 1, 1, 1], kernel_shape=[4, 4])
        add_init(f"bn{i}.s", _f32(dc["bn"]["scale"]))
        add_init(f"bn{i}.b", _f32(dc["bn"]["bias"]))
        add_init(f"bn{i}.m", _f32(bn["mean"]))
        add_init(f"bn{i}.v", _f32(bn["var"]))
        add("BatchNormalization",
            [f"dc{i}.out", f"bn{i}.s", f"bn{i}.b", f"bn{i}.m", f"bn{i}.v"],
            [f"bn{i}.out"], epsilon=1e-5)
        add("Relu", [f"bn{i}.out"], [f"relu{i}"])
        x = f"relu{i}"
    kf = hd.final_conv_kernel
    add_init("final.w", conv_weight_to_torch(head["final_w"]))
    add_init("final.b", _f32(head["final_b"]))
    fpad = kf // 2
    add("Conv", [x, "final.w", "final.b"], ["output"],
        strides=[1, 1], pads=[fpad] * 4, kernel_shape=[kf, kf])

    H, W = bb.img_size
    up = 2 ** len(hd.deconv_kernels)    # each k4 s2 stage doubles H, W
    g = P.graph(
        nodes, f"vitpose_{cfg.name}_{cfg.dataset}",
        inputs=[P.value_info("input", P.FLOAT, [batch_dim, bb.in_chans, H, W])],
        outputs=[P.value_info("output", P.FLOAT,
                              [batch_dim, K, up * Ph, up * Pw])],
        initializers=init,
        doc_string=("ViTPose (easy_vitpose_tpu) — NCHW normalized crops -> "
                    "K heatmaps; parity graph of models/vitpose.py"),
    )
    return P.model(g, opset=17, ir_version=8,
                   doc_string="exported by easy_vitpose_tpu (see export.py "
                              "of the reference for the torch twin)")
