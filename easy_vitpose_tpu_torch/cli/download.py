"""Model-zoo fetcher — replaces the reference's ``models/download.sh`` and
the colab ``hf_hub_download`` cell (reference models/download.sh:1-4,
colab_demo.ipynb "Download the models").

Port of ``easy_vitpose_tpu/cli/download.py`` (stdlib only; ``--convert``
goes through the port's converters).

Fetches released checkpoints from the ``JunkyByte/easy_ViTPose`` HuggingFace
zoo over plain HTTPS with stdlib urllib (no huggingface_hub dependency) and
optionally converts them to ``.npz`` in one step, so

  python -m easy_vitpose_tpu_torch.cli.download --model-name b --dataset coco \\
      --yolo-size s --dest models/ --convert

leaves ``models/vitpose-b-coco.npz`` + ``models/yolov8s.npz`` ready for
``VitInference``.  Zoo layout (colab_demo.ipynb download cell):

  torch/{dataset}/vitpose-{size}-{dataset}.pth
  yolov8/yolov8{yolo_size}.pt

``--base-url`` points at any mirror (or a local server in tests); downloads
stream to a ``.part`` file and are renamed only when complete, so an
interrupted fetch never leaves a truncated checkpoint behind.
"""
from __future__ import annotations

import argparse
import os
import sys
import urllib.error
import urllib.request

DEFAULT_BASE_URL = "https://huggingface.co/JunkyByte/easy_ViTPose/resolve/main"
# Datasets with released checkpoints in the zoo (colab_demo.ipynb DATASET
# param; 'custom' has no published weights).
ZOO_DATASETS = ("coco", "coco_25", "wholebody", "mpii", "aic", "ap10k",
                "apt36k")
ZOO_YOLO_SIZES = ("n", "s", "m", "l", "x")


def vitpose_zoo_path(dataset: str, size: str) -> str:
    return f"torch/{dataset}/vitpose-{size}-{dataset}.pth"


def yolo_zoo_path(size: str) -> str:
    return f"yolov8/yolov8{size}.pt"


def fetch(url: str, dest: str, *, force: bool = False, quiet: bool = False,
          chunk: int = 1 << 20) -> str:
    """Stream ``url`` to ``dest`` (atomic via ``dest + '.part'``)."""
    if os.path.exists(dest) and not force:
        if not quiet:
            print(f"exists, skipping: {dest}")
        return dest
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    part = dest + ".part"
    req = urllib.request.Request(url, headers={"User-Agent": "easy-vitpose-tpu"})
    try:
        with urllib.request.urlopen(req) as r, open(part, "wb") as f:
            total = int(r.headers.get("Content-Length") or 0)
            done = 0
            while True:
                buf = r.read(chunk)
                if not buf:
                    break
                f.write(buf)
                done += len(buf)
                if not quiet and total:
                    pct = 100.0 * done / total
                    print(f"\r{dest}: {done/1e6:.1f}/{total/1e6:.1f} MB "
                          f"({pct:.0f}%)", end="", flush=True)
            if not quiet:
                print()
    except urllib.error.URLError as e:
        if os.path.exists(part):
            os.remove(part)
        raise SystemExit(
            f"download failed: {url}\n  {e}\n"
            "This environment may have no network egress. Fetch the file on "
            "a connected machine (see models/download.sh in the reference or "
            f"{DEFAULT_BASE_URL}) and point --dest / the CLIs at the local "
            "copy; `cli/convert` turns .pth/.pt into native .npz offline.")
    os.replace(part, dest)
    return dest


def main(argv=None, model_cfg=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-name", default=None, choices=["s", "b", "l", "h"],
                   help="ViTPose size to fetch (omit to fetch YOLO only)")
    p.add_argument("--dataset", default="coco", choices=ZOO_DATASETS)
    p.add_argument("--yolo-size", default=None, choices=ZOO_YOLO_SIZES,
                   help="YOLOv8 detector size to fetch (omit to skip)")
    p.add_argument("--dest", default="models", help="output directory")
    p.add_argument("--base-url", default=DEFAULT_BASE_URL,
                   help="zoo root (override for mirrors / offline tests)")
    p.add_argument("--convert", action="store_true",
                   help="also convert fetched checkpoints to native .npz")
    p.add_argument("--force", action="store_true", help="re-download")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.model_name is None and args.yolo_size is None:
        p.error("nothing to do: pass --model-name and/or --yolo-size")

    base = args.base_url.rstrip("/")
    got = []
    if args.model_name is not None:
        rel = vitpose_zoo_path(args.dataset, args.model_name)
        dest = os.path.join(args.dest, os.path.basename(rel))
        got.append(("vitpose", fetch(f"{base}/{rel}", dest, force=args.force,
                                     quiet=args.quiet)))
    if args.yolo_size is not None:
        rel = yolo_zoo_path(args.yolo_size)
        dest = os.path.join(args.dest, os.path.basename(rel))
        got.append(("yolo", fetch(f"{base}/{rel}", dest, force=args.force,
                                  quiet=args.quiet)))

    if args.convert:
        for kind, path in got:
            out = os.path.splitext(path)[0] + ".npz"
            if kind == "vitpose":
                import torch

                from ..configs import get_model_config
                from ..convert.vitpose_torch import convert_vitpose_state_dict
                from ..utils.checkpoint import save_params
                cfg = (model_cfg if model_cfg is not None else
                       get_model_config(args.dataset, args.model_name))
                ckpt = torch.load(path, map_location="cpu", weights_only=True)
                save_params(out, convert_vitpose_state_dict(ckpt, cfg))
            else:
                from .convert import main as convert_main
                convert_main(["yolo", "--ckpt", path, "--out", out])
            if not args.quiet:
                print(f"converted -> {out}")

    for _, path in got:
        print(path)
    return [path for _, path in got]


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
