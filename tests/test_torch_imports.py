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
    "easy_vitpose_tpu_torch.convert.model_split",
    "easy_vitpose_tpu_torch.convert.vitpose_plus",
    "easy_vitpose_tpu_torch.convert.yolo_torch",
    "easy_vitpose_tpu_torch.export",
    "easy_vitpose_tpu_torch.export.onnx_proto",
    "easy_vitpose_tpu_torch.export.onnx_ref",
    "easy_vitpose_tpu_torch.export.onnx_vitpose",
    "easy_vitpose_tpu_torch.export.aot",
    "easy_vitpose_tpu_torch.cli.convert",
    "easy_vitpose_tpu_torch.cli.export",
    "easy_vitpose_tpu_torch.cli.eval_coco",
    "easy_vitpose_tpu_torch.cli.download",
    "easy_vitpose_tpu_torch.models.stem",
    "easy_vitpose_tpu_torch.models.moe",
    "easy_vitpose_tpu_torch.train.moe_step",
    "easy_vitpose_tpu_torch.train.mesh_losses",
    "easy_vitpose_tpu_torch.ops.group",
    "easy_vitpose_tpu_torch.native",
    "easy_vitpose_tpu_torch.parallel",
    "easy_vitpose_tpu_torch.parallel.comm",
    "easy_vitpose_tpu_torch.parallel.mesh",
    "easy_vitpose_tpu_torch.parallel.tp",
    "easy_vitpose_tpu_torch.parallel.pp",
    "easy_vitpose_tpu_torch.version",
    "easy_vitpose_tpu_torch.utils.logging",
    "easy_vitpose_tpu_torch.utils.profiling",
    "easy_vitpose_tpu_torch.utils.precision",
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


def test_top_level_exports_vitinference_and_version():
    """The package's public API is the JAX package's: ``VitInference`` (the
    class of ``pipeline/inference.py``) and ``__version__``, the same
    ``__all__``; another name raises AttributeError."""
    import easy_vitpose_tpu
    import easy_vitpose_tpu_torch
    from easy_vitpose_tpu_torch.pipeline import inference

    assert easy_vitpose_tpu_torch.VitInference is inference.VitInference
    from easy_vitpose_tpu_torch import VitInference, __version__
    assert VitInference is inference.VitInference
    assert __version__ == easy_vitpose_tpu.__version__ == "0.1.0"
    assert easy_vitpose_tpu_torch.__all__ == easy_vitpose_tpu.__all__
    try:
        easy_vitpose_tpu_torch.NotAName
    except AttributeError as e:
        assert "NotAName" in str(e)
    else:
        raise AssertionError("an unknown attribute did not raise")
    assert not hasattr(easy_vitpose_tpu_torch, "EVT_FORCE_CPU")


def test_package_import_stays_light():
    """``import easy_vitpose_tpu_torch`` loads neither the pipeline nor JAX
    (checked in a fresh interpreter); reading ``VitInference`` loads the
    pipeline, still without JAX."""
    code = ("import sys\n"
            "import easy_vitpose_tpu_torch as p\n"
            "heavy = lambda: sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'easy_vitpose_tpu') or m.startswith('easy_vitpose_tpu_torch.pipeline'))\n"
            "print(','.join(heavy()))\n"
            "p.VitInference\n"
            "print('easy_vitpose_tpu_torch.pipeline.inference' in sys.modules, "
            "any(m.split('.')[0] == 'jax' for m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    before, after = out.stdout.split("\n")[:2]
    assert before == ""
    assert after == "True False"
