"""PyTorch port: the package's remainder against the JAX package on the CPU.

* ``utils/logging.py``: the same handlers, levels, format and output as
  JAX's ``get_logger`` / ``print_log`` / ``master_only`` on the same calls,
  on the main process and (the gate patched) on another rank;
* ``utils/profiling.py``: ``StageTimer``'s summary keys, call counts and
  report lines against JAX's on the same stages; ``device_trace`` writes
  a torch.profiler trace;
* ``utils/io.py``: ``save_image_grid`` writes JAX's PNG bytes on a batch
  seeded with numpy; ``check_video_rotation`` gives JAX's answer on the
  same (patched) ffprobe output, and 0 without ffprobe;
* ``native.native_available`` agrees with whether ``nms_cpu`` runs the
  compiled library;
* pyproject.toml's ``vitpose-torch-*`` console scripts resolve to the
  port's CLI ``main``s, and the JAX entries are unchanged;
* every public function and class of the JAX package (by ``ast``) has a
  counterpart in the port, by name or in :data:`RENAMED`, or stands in
  :data:`NOT_PORTED` with its reason (ROADMAP's "Not to port" list).

Exact comparisons throughout: no arithmetic differs.
"""
import ast
import io
import json
import logging
import os
import re
import shutil
import subprocess
import tomllib

import numpy as np
import pytest

from easy_vitpose_tpu.utils import io as jio
from easy_vitpose_tpu.utils import logging as jlog
from easy_vitpose_tpu.utils import profiling as jprof
from easy_vitpose_tpu_torch.utils import io as tio
from easy_vitpose_tpu_torch.utils import logging as tlog
from easy_vitpose_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "easy_vitpose_tpu", "easy_vitpose_tpu_torch"


# ------------------------------------------------------------------ logging
def handler_shape(logger):
    return [(type(h).__name__, h.formatter._fmt) for h in logger.handlers]


def strip_time(text: str) -> list:
    """Log lines without their timestamp and logger name."""
    return [re.sub(r"^\S+ \S+ - \S+ - ", "", line) for line in text.splitlines()]


def log_some(logger):
    logger.debug("a debug line")
    logger.info("an info line")
    logger.warning("a warning")
    logger.error("an error")


@pytest.mark.parametrize("main", [True, False])
def test_get_logger_matches_jax(tmp_path, monkeypatch, main):
    """The same handlers (a stream handler, and a file handler on the main
    process only), format, level and propagation; the same lines reach the
    file; a second call returns the logger as it is."""
    monkeypatch.setattr(jlog, "_process_index", lambda: 0 if main else 1)
    monkeypatch.setattr(tlog, "is_main_process", lambda: main)
    names = {pkg: f"{pkg}.test_logger_{main}" for pkg in ("jax", "torch")}
    files = {pkg: tmp_path / f"{pkg}.log" for pkg in names}
    loggers = {"jax": jlog.get_logger(names["jax"], log_file=str(files["jax"])),
               "torch": tlog.get_logger(names["torch"], log_file=str(files["torch"]))}
    j, t = loggers["jax"], loggers["torch"]
    assert handler_shape(t) == handler_shape(j)
    assert len(t.handlers) == (2 if main else 1)
    assert t.level == j.level == (logging.INFO if main else logging.ERROR)
    assert t.propagate is j.propagate is False
    for lg in (j, t):
        lg.handlers[0].stream = io.StringIO()        # keep the test's stderr quiet
        log_some(lg)
        for h in lg.handlers:
            h.flush()
    if main:
        assert strip_time(files["torch"].read_text()) == strip_time(files["jax"].read_text()) == [
            "INFO - an info line", "WARNING - a warning", "ERROR - an error"]
    else:
        assert not files["torch"].exists() and not files["jax"].exists()
    assert tlog.get_logger(names["torch"], log_level=logging.DEBUG) is t
    assert handler_shape(tlog.get_logger(names["torch"])) == handler_shape(j)
    for lg in (j, t):
        for h in lg.handlers:
            h.close()
        lg.handlers.clear()


@pytest.mark.parametrize("target", ["none", "logger", "silent", "name", "invalid"])
def test_print_log_dispatch_matches_jax(capsys, target):
    """``print_log``'s print / Logger / 'silent' / logger-name dispatch and
    its TypeError, captured for both packages."""
    outputs = []
    for pkg, mod in (("jax", jlog), ("torch", tlog)):
        name = f"{pkg}.print_log_{target}"
        lg = mod.get_logger(name)
        lg.handlers[0].stream = io.StringIO()
        arg = {"none": None, "logger": lg, "silent": "silent", "name": name,
               "invalid": 3.5}[target]
        if target == "invalid":
            with pytest.raises(TypeError):
                mod.print_log("msg", arg)
        else:
            mod.print_log("msg", arg, level=logging.WARNING)
        outputs.append((capsys.readouterr().out, strip_time(lg.handlers[0].stream.getvalue())))
        lg.handlers.clear()
    assert outputs[0] == outputs[1]
    want_out = "msg\n" if target == "none" else ""
    want_log = ["WARNING - msg"] if target in ("logger", "name") else []
    assert outputs[1] == (want_out, want_log)


@pytest.mark.parametrize("main", [True, False])
def test_master_only_matches_jax(monkeypatch, main):
    """The wrapped function runs on the main process only; elsewhere None."""
    monkeypatch.setattr(jlog, "_process_index", lambda: 0 if main else 1)
    monkeypatch.setattr(tlog, "is_main_process", lambda: main)
    calls = []

    def fn(x, y=1):
        """Doc."""
        calls.append(x)
        return x + y

    got = (jlog.master_only(fn)(2, y=3), tlog.master_only(fn)(2, y=3))
    assert got == ((5, 5) if main else (None, None))
    assert calls == ([2, 2] if main else [])
    assert tlog.master_only(fn).__doc__ == "Doc." and tlog.master_only(fn).__name__ == "fn"


def test_logging_gate_is_the_process_group_rank(monkeypatch):
    """Without a process group the port's gate is the main process (JAX's
    ``process_index`` 0 on one host)."""
    from easy_vitpose_tpu_torch.parallel import mesh
    assert tlog.is_main_process is mesh.is_main_process
    assert mesh.is_main_process() and jlog._process_index() == 0


# ---------------------------------------------------------------- profiling
def drive(timer):
    for name in ("detect", "pose", "detect", "track", "pose", "pose"):
        with timer.stage(name):
            pass
    with pytest.raises(KeyError):
        with timer.stage("fails"):
            raise KeyError("x")


def test_stage_timer_matches_jax():
    """The same summary keys and fields, call counts and report lines (the
    times aside) on the same stages, a stage that raises included."""
    j, t = jprof.StageTimer(), tprof.StageTimer()
    drive(j)
    drive(t)
    sj, st = j.summary(), t.summary()
    assert list(st) == list(sj) == ["detect", "pose", "track", "fails"]
    for k in sj:
        assert list(st[k]) == list(sj[k]) == ["total_s", "calls", "mean_ms"]
        assert st[k]["calls"] == sj[k]["calls"]
        assert st[k]["total_s"] >= 0 and st[k]["mean_ms"] >= 0
    number = re.compile(r"\d+\.\d\d")
    assert [number.sub("T", line) for line in t.report().splitlines()] == \
        [number.sub("T", line) for line in j.report().splitlines()]
    assert t.report().splitlines()[0].startswith("  detect ") and " ms x 2" in t.report()


def test_device_trace_writes_a_trace(tmp_path):
    """``device_trace`` writes ``logdir/trace.json`` (Chrome trace events)
    for the block, and also when the block raises."""
    import torch
    with tprof.device_trace(str(tmp_path / "a")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "a" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError):
        with tprof.device_trace(str(tmp_path / "b")):
            raise RuntimeError("x")
    assert (tmp_path / "b" / "trace.json").exists()


# ----------------------------------------------------------------------- io
@pytest.mark.parametrize("n,cols,pad,channels", [(6, 4, 2, 3), (4, 2, 0, 4), (1, 3, 5, 3)])
def test_save_image_grid_bytes_match_jax(tmp_path, n, cols, pad, channels):
    """The same PNG bytes as JAX's ``save_image_grid`` on a seeded batch."""
    images = np.random.default_rng(n + cols).integers(0, 256, (n, 21, 30, channels),
                                                      dtype=np.uint8)
    jio.save_image_grid(str(tmp_path / "j.png"), list(images), cols=cols, pad=pad)
    tio.save_image_grid(str(tmp_path / "t.png"), images, cols=cols, pad=pad)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


ROTATION_CASES = {
    "rotate_90": {"streams": [{"tags": {"rotate": "90"}}]},
    "rotate_270": {"streams": [{"index": 0}, {"tags": {"rotate": "-90"}}]},
    "rotate_180": {"streams": [{"tags": {"rotate": 180}}]},
    "side_data_-90": {"streams": [{"side_data_list": [{"displaymatrix": "x"},
                                                      {"rotation": -90}]}]},
    "side_data_90": {"streams": [{"side_data_list": [{"rotation": 90}]}]},
    "side_data_-180": {"streams": [{"side_data_list": [{"rotation": -180}]}]},
    "side_data_45": {"streams": [{"side_data_list": [{"rotation": 45}]}]},
    "none": {"streams": [{"tags": {}}, {"side_data_list": None}]},
    "empty": None,
    "not_json": b"ffprobe: garbage",
    "bad_number": {"streams": [{"tags": {"rotate": "upside"}}]},
    "timeout": "timeout",
}


@pytest.mark.parametrize("case", list(ROTATION_CASES))
def test_check_video_rotation_matches_jax(monkeypatch, case):
    """ffprobe's JSON (``shutil.which`` and ``subprocess.run`` patched) read
    into the same rotation as JAX's: the ``rotate`` tag, else the
    ``side_data_list`` rotation; 0 for none, an unreadable probe or a
    timeout."""
    out = ROTATION_CASES[case]
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        if out == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
        stdout = out if isinstance(out, bytes) else (b"" if out is None
                                                     else json.dumps(out).encode())
        return subprocess.CompletedProcess(cmd, 0, stdout=stdout, stderr=b"")

    monkeypatch.setattr(shutil, "which", lambda name: "/bin/" + name)
    monkeypatch.setattr(subprocess, "run", run)
    got, want = tio.check_video_rotation("clip.mp4"), jio.check_video_rotation("clip.mp4")
    assert got == want
    assert got == {"rotate_90": 270, "rotate_270": 90, "rotate_180": 180, "side_data_-90": 90,
                   "side_data_90": 270, "side_data_-180": 180}.get(case, 0)
    assert seen[0] == seen[1] and seen[0][0] == "ffprobe" and seen[0][-1] == "clip.mp4"


def test_check_video_rotation_without_ffprobe(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("ffprobe was run"))
    assert tio.check_video_rotation("clip.mp4") == jio.check_video_rotation("clip.mp4") == 0


# ------------------------------------------------------------------- native
def test_native_available_agrees_with_nms_cpu():
    """A bool; true exactly when ``nms_cpu`` runs the compiled library,
    whose kept rows then equal the plain version's."""
    from easy_vitpose_tpu_torch import native
    from easy_vitpose_tpu_torch.ops.oks import bbox_nms
    avail = native.native_available()
    assert isinstance(avail, bool)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (40, 2))
    dets = np.concatenate([xy, xy + rng.uniform(5, 40, (40, 2)), rng.uniform(0, 1, (40, 1))],
                          1).astype(np.float32)
    if avail:
        assert native._lib is not None
        assert native.nms_cpu(dets, 0.5) == bbox_nms(dets, 0.5)
    else:
        with pytest.raises(RuntimeError):
            native.nms_cpu(dets, 0.5)


# ------------------------------------------------------------ console scripts
TOOLS = ("infer", "train", "convert", "export", "eval-coco", "serve", "serve-http", "download")


def scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("tool", TOOLS)
def test_console_script_resolves_to_the_ports_main(tool):
    """``vitpose-torch-<tool>`` is ``easy_vitpose_tpu_torch.cli.<tool>:main``,
    a callable; ``vitpose-<tool>`` still names the JAX CLI."""
    import importlib
    mod = tool.replace("-", "_")
    entry = scripts()[f"vitpose-torch-{tool}"]
    assert entry == f"{PORT_PKG}.cli.{mod}:main"
    module, attr = entry.split(":")
    assert callable(getattr(importlib.import_module(module), attr))
    assert scripts()[f"vitpose-{tool}"] == f"{JAX_PKG}.cli.{mod}:main"


def test_console_scripts_are_the_two_sets():
    assert sorted(scripts()) == sorted([f"vitpose-{t}" for t in TOOLS]
                                       + [f"vitpose-torch-{t}" for t in TOOLS])


# ---------------------------------------------------- the two packages' names
# a JAX name whose port counterpart has another name: "module::name" in the port
RENAMED = {
    "nms_fixed": "detect/yolo.py::nms_fixed_plain",
    "letterbox_sample": "detect/yolo.py::letterbox_sample_plain",
    "make_fused_block_train": "models/fused_block_train.py::fused_block_train",
    "batch_norm": "models/head.py::batch_norm_train",
    "init_head_params": "models/vitpose.py::init_params",
    "init_vit_params": "models/vitpose.py::init_params",
    "init_vitpose_params": "models/vitpose.py::init_params",
    "init_stem_params": "models/vitpose.py::init_params",
    "is_q8_blocks": "models/quant.py::QBlock",
    "attention": "models/vit.py::attention_core",
    "mlp": "models/vit.py::block_plain",
    "generate_gaussian_targets_jnp": "ops/heatmap.py::generate_gaussian_targets",
    "udp_modulate_pallas": "ops/modulate.py::udp_modulate",
    "sample_crops_pallas": "ops/sampler.py::crop_normalize",
}
_JIT = "a jax.jit wrapper: the port captures CUDA graphs (pipeline/graphs.py)"
# ROADMAP's "Not to port" list: a JAX name with no counterpart, and why
NOT_PORTED = {
    "conv_transpose_s2": "a wrapper of one op the port calls directly (F.conv_transpose2d)",
    "conv_transpose_s2_phase": "a TPU lowering of the transposed convolution",
    "conv_transpose_s2_packed": "a TPU lowering of the transposed convolution (a recorded null)",
    "conv2d": "a wrapper of one op the port calls directly (F.conv2d)",
    "sample_crops_matmul": "an MXU formulation of the crop sampler",
    "sample_crops_matmul_q8": "an MXU formulation of the crop sampler (a recorded null)",
    "make_train_step_inbwd": "train/fast_step.py, a recorded null",
    "jit_data_parallel": "GSPMD propagation: the port's DP step is make_train_step_sharded",
    "tp_shardings": "GSPMD shardings: the port's TP layout is parallel/tp.py::RULES",
    "jit_tensor_parallel": "GSPMD propagation: the port's TP step is make_tp_train_step",
    "replicated": "a GSPMD NamedSharding: the port copies with parallel/mesh.py::replicate",
    "batch_sharded": "a GSPMD NamedSharding: the port splits with parallel/mesh.py::shard_batch",
    "pose_step_jit": _JIT,
    "detect_frame_jit": _JIT,
    "detect_batch_jit": _JIT,
    "detect_pose_jit": _JIT,
    "detect_pose_multi_jit": _JIT,
    "enable_nan_checks": "utils/debug.py, JAX tooling",
    "no_jit": "utils/debug.py, JAX tooling",
    "tree_compare": "utils/debug.py, JAX tooling",
    "enable_persistent_cache": "utils/compile_cache.py, XLA's compilation cache",
    "default_block_impl": "the TPU gate of the pose step: a tensor's device picks the kernel "
                          "or its plain version",
    "resolve_opt_flavor": "EVT_FUSED_OPT's Pallas-or-XLA choice by backend: a tensor's device "
                          "picks K8/K9 or the plain version",
}


def public_names(pkg: str) -> dict:
    """Top-level public functions and classes by name -> the modules
    (relative paths) that define them."""
    root = os.path.join(REPO, pkg)
    out = {}
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                for node in tree.body:
                    if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                            and not node.name.startswith("_")):
                        out.setdefault(node.name, set()).add(os.path.relpath(path, root))
    return out


def test_every_public_jax_name_is_ported_or_listed():
    """Each public JAX function or class has a port counterpart of the same
    name, or one named in RENAMED (which the port defines in that module),
    or a reason in NOT_PORTED; neither list names a JAX name that the
    port has by name or that JAX lacks, and the lists do not overlap."""
    jax_names, port_names = public_names(JAX_PKG), public_names(PORT_PKG)
    missing = set(jax_names) - set(port_names)
    assert missing == set(RENAMED) | set(NOT_PORTED), sorted(
        missing ^ (set(RENAMED) | set(NOT_PORTED)))
    assert not set(RENAMED) & set(NOT_PORTED)
    for name, target in RENAMED.items():
        module, port_name = target.split("::")
        assert module in port_names.get(port_name, set()), (name, target)
    assert all(len(reason) > 10 for reason in NOT_PORTED.values())
    assert len(jax_names) > 250 and len(port_names) > len(jax_names)
