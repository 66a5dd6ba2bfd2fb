"""Checkpoint conversion CLI: torch .pth -> the JAX package's .npz format,
ultralytics .pt -> .npz, ViTPose+ -> one multi-task .npz or six
single-task ones, .npz -> .pth, and weight averaging.

Port of ``easy_vitpose_tpu/cli/convert.py``, with its subcommands and
flags; numpy and torch only, and the files it writes hold the same keys
and the same arrays as the JAX package's CLI writes from the same input.

Usage:
  python -m easy_vitpose_tpu_torch.cli.convert vitpose --ckpt vitpose-b-coco.pth \\
      --model-name b --out vitpose-b-coco.npz
  python -m easy_vitpose_tpu_torch.cli.convert yolo --ckpt yolov8n.pt --out yolov8n.npz
  python -m easy_vitpose_tpu_torch.cli.convert plus --ckpt vitpose+-b.pth \\
      --model-name b --out vitpose-b-plus.npz
  python -m easy_vitpose_tpu_torch.cli.convert split --source vitpose+-b.pth \\
      --target split/ --model-name b
  python -m easy_vitpose_tpu_torch.cli.convert to-torch --ckpt vitpose-b-coco.npz \\
      --model-name b --out vitpose-b-coco.pth   # inverse: back to the reference
  python -m easy_vitpose_tpu_torch.cli.convert average --ckpts a.npz b.npz --out soup.npz
"""
from __future__ import annotations

import argparse

from ..configs import get_model_config, infer_dataset_by_path


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("vitpose")
    pv.add_argument("--ckpt", required=True)
    pv.add_argument("--model-name", required=True, choices=["s", "b", "l", "h"])
    pv.add_argument("--dataset", default=None)
    pv.add_argument("--out", required=True)

    py = sub.add_parser("yolo")
    py.add_argument("--ckpt", required=True)
    py.add_argument("--out", required=True)

    pp = sub.add_parser("plus", help="convert a ViTPose+ MoE checkpoint to "
                        "ONE multi-task .npz (all experts + heads; serve "
                        "any task with VitInference(task=...))")
    pp.add_argument("--ckpt", required=True)
    pp.add_argument("--model-name", default="b", choices=["s", "b", "l", "h"])
    pp.add_argument("--out", required=True)

    pt = sub.add_parser("to-torch", help="inverse conversion: .npz -> "
                        "reference-format torch .pth (a finetuned "
                        "checkpoint back into the torch/ONNX/TRT ecosystem)")
    pt.add_argument("--ckpt", required=True, help=".npz checkpoint")
    pt.add_argument("--model-name", required=True, choices=["s", "b", "l", "h"])
    pt.add_argument("--dataset", default=None)
    pt.add_argument("--out", required=True, help="output .pth path")

    pa = sub.add_parser("average", help="uniform weight averaging (model "
                        "soup) of N same-shape .npz checkpoints — e.g. the "
                        "top-k epoch snapshots of one run")
    pa.add_argument("--ckpts", nargs="+", required=True)
    pa.add_argument("--out", required=True)

    ps = sub.add_parser("split", help="split a ViTPose+ MoE checkpoint into "
                        "per-dataset single-head .npz checkpoints "
                        "(reference model_split.py equivalent)")
    ps.add_argument("--source", required=True)
    ps.add_argument("--target", required=True, help="output directory")
    ps.add_argument("--prefix", default="vitpose-")
    ps.add_argument("--model-name", default="b", choices=["s", "b", "l", "h"])

    args = p.parse_args(argv)
    if args.cmd == "to-torch":
        from ..convert.vitpose_torch import save_torch_checkpoint
        from ..utils.checkpoint import load_params
        dataset = args.dataset or infer_dataset_by_path(args.ckpt)
        params = load_params(args.ckpt)
        k = None
        try:  # head width may differ from the dataset default (K-mismatch finetunes)
            k = int(params["head"]["final_b"].shape[0])
        except (KeyError, TypeError, AttributeError, IndexError):
            pass
        cfg = get_model_config(dataset, args.model_name, num_keypoints=k)
        save_torch_checkpoint(params, cfg, args.out)
        print(f"wrote {args.out} (reference-format torch state dict, "
              f"{dataset}, {args.model_name})")
        return
    if args.cmd == "average":
        average_checkpoints(args.ckpts, args.out)
        return
    if args.cmd == "plus":
        import torch
        from ..convert.vitpose_plus import convert_vitpose_plus_state_dict
        from ..utils.checkpoint import save_params
        ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        cfg = get_model_config("coco", args.model_name)
        params = convert_vitpose_plus_state_dict(ckpt, cfg)
        save_params(args.out, params)
        print(f"wrote {args.out} (multi-task: "
              f"{', '.join(sorted(params['heads']))})")
        return
    if args.cmd == "split":
        from ..convert.model_split import split_checkpoint_file
        paths = split_checkpoint_file(args.source, args.target, prefix=args.prefix,
                                      size=args.model_name)
        for path in paths.values():
            print(f"wrote {path}")
        return
    if args.cmd == "vitpose":
        import torch
        from ..convert.vitpose_torch import convert_vitpose_state_dict
        from ..utils.checkpoint import save_params
        dataset = args.dataset or infer_dataset_by_path(args.ckpt)
        cfg = get_model_config(dataset, args.model_name)
        ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        save_params(args.out, convert_vitpose_state_dict(ckpt, cfg))
        print(f"wrote {args.out} ({dataset}, {args.model_name})")
    else:
        from ..convert.yolo_torch import load_ultralytics_checkpoint, save_yolo_npz
        params, scale, nc = load_ultralytics_checkpoint(args.ckpt)
        save_yolo_npz(args.out, params, scale, nc)
        print(f"wrote {args.out} (yolov8{scale}, nc={nc})")


def average_checkpoints(paths, out: str) -> None:
    """Write the uniform mean of same-structure ``.npz`` checkpoints: float
    leaves averaged in float64 and cast back, other leaves (step counters)
    the first checkpoint's.  Exits naming the first checkpoint whose
    structure or shapes differ."""
    import numpy as np

    from ..convert.from_jax import tree_map
    from ..utils.checkpoint import flatten_params, load_params, save_params

    trees = [load_params(c) for c in paths]

    def layout(tree):
        return [(k, np.shape(v)) for k, v in sorted(flatten_params(tree).items())]

    ref = layout(trees[0])
    for c, t in zip(paths[1:], trees[1:]):
        if layout(t) != ref:
            raise SystemExit(f"{c}: checkpoint structure differs from {paths[0]}")
    n = len(trees)

    def avg_leaf(*leaves):
        a0 = np.asarray(leaves[0])
        if not np.issubdtype(a0.dtype, np.floating):
            return a0  # int buffers (e.g. step counters) keep the first
        acc = sum(np.asarray(leaf, np.float64) for leaf in leaves) / n
        return acc.astype(a0.dtype)

    save_params(out, tree_map(avg_leaf, *trees))
    print(f"wrote {out} (uniform average of {n} checkpoints)")


if __name__ == "__main__":
    main()
