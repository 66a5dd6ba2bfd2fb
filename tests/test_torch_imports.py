"""The PyTorch port imports neither JAX nor the JAX package.

The check runs in a fresh interpreter: this test process has already
imported JAX (tests/conftest.py), so an in-process look at sys.modules would
prove nothing.  A source scan backs it up, and must not flag the port's own
name ``easy_vitpose_tpu_torch``.
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "easy_vitpose_tpu_torch")
MODULES = [
    "easy_vitpose_tpu_torch",
    "easy_vitpose_tpu_torch.configs",
    "easy_vitpose_tpu_torch.kernels",
    "easy_vitpose_tpu_torch.convert.from_jax",
    "easy_vitpose_tpu_torch.models.vit",
    "easy_vitpose_tpu_torch.models.fused_block",
    "easy_vitpose_tpu_torch.models.fused_block_train",
    "easy_vitpose_tpu_torch.models.quant",
    "easy_vitpose_tpu_torch.models.head",
    "easy_vitpose_tpu_torch.models.vitpose",
    "easy_vitpose_tpu_torch.ops.preprocess",
    "easy_vitpose_tpu_torch.ops.sampler",
    "easy_vitpose_tpu_torch.ops.decode",
    "easy_vitpose_tpu_torch.ops.modulate",
    "easy_vitpose_tpu_torch.ops.affine",
    "easy_vitpose_tpu_torch.ops.heatmap",
    "easy_vitpose_tpu_torch.pipeline.pose_step",
    "easy_vitpose_tpu_torch.pipeline.fused_detect",
    "easy_vitpose_tpu_torch.pipeline.inference",
    "easy_vitpose_tpu_torch.pipeline.stream",
    "easy_vitpose_tpu_torch.pipeline.autotune",
    "easy_vitpose_tpu_torch.pipeline.graphs",
    "easy_vitpose_tpu_torch.detect.yolo",
    "easy_vitpose_tpu_torch.track.kalman",
    "easy_vitpose_tpu_torch.track.sort",
    "easy_vitpose_tpu_torch.track.bytetrack",
    "easy_vitpose_tpu_torch.ops.one_euro",
    "easy_vitpose_tpu_torch.skeletons",
    "easy_vitpose_tpu_torch.skeletons_data",
    "easy_vitpose_tpu_torch.convert.vitpose_torch",
    "easy_vitpose_tpu_torch.utils.checkpoint",
    "easy_vitpose_tpu_torch.utils.io",
    "easy_vitpose_tpu_torch.utils.visualization",
    "easy_vitpose_tpu_torch.cli.infer",
    "easy_vitpose_tpu_torch.cli.serve",
    "easy_vitpose_tpu_torch.cli.serve_http",
    "easy_vitpose_tpu_torch.train",
    "easy_vitpose_tpu_torch.train.losses",
    "easy_vitpose_tpu_torch.train.fused_opt",
    "easy_vitpose_tpu_torch.train.step",
    "easy_vitpose_tpu_torch.train.dataset",
    "easy_vitpose_tpu_torch.train.loop",
    "easy_vitpose_tpu_torch.train.presets",
    "easy_vitpose_tpu_torch.train.resilient",
    "easy_vitpose_tpu_torch.train.state_ckpt",
    "easy_vitpose_tpu_torch.eval",
    "easy_vitpose_tpu_torch.eval.metrics",
    "easy_vitpose_tpu_torch.eval.cocoeval",
    "easy_vitpose_tpu_torch.ops.oks",
    "easy_vitpose_tpu_torch.cli.train",
]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|easy_vitpose_tpu)\b(?!_torch)", re.M)


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'easy_vitpose_tpu')]\n"
              "print(','.join(sorted(bad)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "", out.stdout


def test_sources_import_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    hits = [f for f in files if FORBIDDEN.search(open(f).read())]
    assert hits == []
    # the pattern sees a real import and not the port's own name
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from easy_vitpose_tpu.ops import decode")
    assert not FORBIDDEN.search("from easy_vitpose_tpu_torch.ops import decode")
