"""Export CLI — both export paths of the reference's export.py:30-97.

Port of ``easy_vitpose_tpu/cli/export.py``, with its flags and flag rules:

  * ``--format aot`` (default): a ``torch.export`` program (``.pt2``) of the
    ViTPose forward for a fixed ``--batch`` (default 64) at ``--dtype``
    bf16 (default), fp32 or int8 (W8A8 weights), exported on ``--device``
    (CUDA unless ``--device cpu``).  The program holds the forward's plain
    ops, not the hand-written kernels (``export/aot.py``), as the JAX
    artifact holds XLA's twin of each block, not the Pallas kernel; load it
    with ``torch.export.load(path).module()``.  An export that fails raises:
    nothing else is written in its place.
  * ``--format onnx``: a real ``.onnx`` artifact with a dynamic batch
    axis (the reference's torch.onnx.export twin, reference
    export.py:50-60), always f32, written by the dependency-free
    serializer (``export/onnx_vitpose.py``), byte for byte the JAX
    package's export of the same weights.

Usage:
  python -m easy_vitpose_tpu_torch.cli.export --model vitpose-b-coco.npz \\
      --model-name b --batch 64 --out vitpose-b-coco.pt2
  python -m easy_vitpose_tpu_torch.cli.export --model vitpose-b-coco.npz \\
      --model-name b --format onnx --out vitpose-b-coco.onnx
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, help=".npz or .pth checkpoint")
    p.add_argument("--model-name", required=True, choices=["s", "b", "l", "h"])
    p.add_argument("--dataset", default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="crop batch size to specialize for (aot only; "
                        "default 64 — onnx exports a dynamic batch axis)")
    p.add_argument("--dtype", default=None,
                   choices=["bf16", "fp32", "int8"],
                   help="aot artifact dtype (default bf16; onnx is always "
                        "f32 like the reference artifact)")
    p.add_argument("--format", default="aot", choices=["aot", "onnx"],
                   help="aot: torch.export program (.pt2, default); "
                        "onnx: .onnx with a dynamic batch axis "
                        "(f32, reference export.py:50-60 twin)")
    p.add_argument("--device", default=None,
                   help="torch device the aot program is exported on and runs on; "
                        "default CUDA ('cpu' for the CPU)")
    p.add_argument("--out", required=True, help="output artifact path")
    args = p.parse_args(argv)
    if args.format == "onnx":
        # don't silently write an f32 graph when the user asked for
        # int8/bf16 or a fixed batch — the onnx artifact is always f32
        # with a dynamic batch axis, like the reference's.
        if args.dtype not in (None, "fp32"):
            p.error(f"--format onnx always exports f32 (got --dtype "
                    f"{args.dtype}); ONNX quantization is not supported")
        if args.batch is not None:
            p.error("--format onnx exports a dynamic batch axis; "
                    "--batch only applies to --format aot")
    else:
        args.batch = 64 if args.batch is None else args.batch
        args.dtype = args.dtype or "bf16"

    import torch

    from .. import configs
    from ..kernels import resolve_device
    from ..pipeline.inference import load_float_model

    device = resolve_device(args.device) if args.format == "aot" else None
    dataset = args.dataset or configs.infer_dataset_by_path(args.model)
    cfg = configs.get_model_config(dataset, args.model_name)
    model = load_float_model(args.model, cfg)

    if args.format == "onnx":
        from ..export.onnx_vitpose import vitpose_to_onnx
        blob = vitpose_to_onnx(model)
        with open(args.out, "wb") as f:
            f.write(blob)
        print(f"wrote {args.out} ({len(blob)} bytes, onnx opset 17, "
              f"dynamic batch)")
        return

    from ..export.aot import export_forward
    from ..models.vitpose import serving_copy

    program = export_forward(serving_copy(model.to(device), args.dtype), args.batch)
    torch.export.save(program, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
          f"batch={args.batch}, {args.dtype}, {device})")


if __name__ == "__main__":
    main()
