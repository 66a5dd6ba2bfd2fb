"""Build, bind and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by its own ``nvcc`` into a
shared library with a plain C interface (``extern "C"``) and loaded with
ctypes.  Pointers and the stream go over as ``c_void_p``; every C entry point
returns ``cudaGetLastError()`` after its launch, and :func:`call` raises if it
is not 0.  The libraries land in ``easy_vitpose_tpu_torch/_build`` (listed in
``.gitignore``), named by a digest of every file in ``csrc/`` and the flags,
so an edited source is rebuilt and an unchanged one is reused.

No ``--use_fast_math``: the int8 row quantisation needs IEEE division and
``rint`` (``models/quant.py``), the fused Adam and its int8-moment flavor
(``train/fused_opt.py``) IEEE division, square root, ``expf`` and ``logf``
to agree with their plain versions bit for bit,
and the plain versions compare at 1e-5.

The launch counters are plain integers per kernel: a wrapper adds one where
it launches its kernel on the card and nowhere else, so a run can show that
the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-lineinfo",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
MAX_TAPS = 32


class Taps(ctypes.Structure):
    """Filter taps passed by value (``struct evt_taps`` in csrc/blur.cuh)."""
    _fields_ = [("v", ctypes.c_float * MAX_TAPS)]


# C entry points of each library: name -> argtypes (all return int, the
# cudaError_t of the launch).  The stream is always the last argument.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "block": {
        # x, w, b, out, rows, cols, eps, x_bf16, w_bf16, out_bf16, stream
        "evt_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
        # a, w, bias, res, out, M, N, K, bf16 (else f32), epilogue, stream
        "evt_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # qkv, o, crops, tokens, dim, heads, scale, bf16, stream
        "evt_attention": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
    "block_q8": {
        # h, q, s, rows, cols, h_bf16, stream
        "evt_rowquant": [_P, _P, _P, _I, _I, _I, _P],
        # q, wq, sx, sw, bias, res, out, M, N, K, epilogue, out_bf16, stream
        "evt_gemm_q8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "sampler": {
        # frames, frame_idx (or null), S, boxes, geo (out), crops (out), M, H, W,
        # OH, OW, mean[3], std[3], out_bf16, stream
        "evt_crop_sample": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                            _F, _F, _F, _F, _F, _F, _I, _P],
    },
    "modulate": {
        # maps, taps, out, n_maps, H, W, radius, stream
        "evt_udp_modulate": [_P, Taps, _P, _I, _I, _I, _I, _P],
        # max dynamic shared memory in bytes, stream
        "evt_udp_modulate_setup": [_I, _P],
    },
    "decode": {
        # heat, heat_bf16, geo, mask, taps, out, points (or null), M, K, H, W,
        # radius, stream
        "evt_decode_keypoints": [_P, _I, _P, _P, Taps, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "train_block": {
        # a, b, M, N, K, lda, ldb, b_kmaj, bf16, mode, bias, res, dp, tokens,
        # aux, out, out2, ldo, stream
        "evt_train_gemm": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _I, _P, _P, _P, _I, _P],
        # src, src_bf16, dp, tokens, dst, dst_bf16, partial, R, C, chunk, stream
        "evt_scale_colsum": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _P],
        # partial, n, C, out, out_bf16, stream
        "evt_colsum_finish": [_P, _I, _I, _P, _I, _P],
        # x, w, dh, res, out, pdw, pdb, R, D, eps, bf16, stream
        "evt_ln_backward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
        # qkv, dO, o, dqkv, stats, B, N, D, heads, qscale, scale, bf16, stream
        "evt_attn_backward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
        # a0, b0, M0, N0, out0, a1, b1, M1, N1, out1, K, bf16, stream
        "evt_train_gemm_tn2": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _I, _I, _P],
        # x, y, out, R, C, hd, stream
        "evt_mma_probe": [_P, _P, _P, _I, _I, _I, _P],
    },
    "adam": {
        # table, leaves, units, scal, b1, 1-b1, b2, 1-b2, eps, stream
        "evt_adam_table": [_P, _I, _L, _P, _F, _F, _F, _F, _F, _P],
    },
    "adam_q8": {
        # table, leaves, units, scal, b1, 1-b1, b2, 1-b2, eps, ln_eps, 1/ln_eps,
        # 1/126, 1/254, tiny, zero_below, stream
        "evt_adam_q8_table": [_P, _I, _L, _P] + [_F] * 11 + [_P],
    },
    "grad_norm": {
        # table, leaves, width, units, partial, out, max_norm, stream
        "evt_grad_norm": [_P, _I, _I, _L, _P, _P, _F, _P],
    },
    "letterbox": {
        # frames, out, S, H, W, cw, ch, new_w, new_h, left, top, scale_x,
        # scale_y, out_bf16, stream
        "evt_letterbox": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    },
    "nms": {
        # boxes, scores, cls, out, S, k, max_det, iou_t, class_aware, left, top,
        # r, stream
        "evt_nms": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _F, _F, _P],
    },
}
SOURCES = tuple(SIGNATURES)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_counts: Dict[str, int] = {}


# ---------------------------------------------------------------- counters
def count_launch(kernel: str) -> None:
    _counts[kernel] = _counts.get(kernel, 0) + 1


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the counters (a CUDA graph's replay adds the
    launches its capture recorded; ``pipeline/graphs.py``)."""
    for kernel, n in counts.items():
        _counts[kernel] = _counts.get(kernel, 0) + n


def launch_counts() -> Dict[str, int]:
    return dict(_counts)


def reset_launch_counts() -> None:
    _counts.clear()


# ------------------------------------------------------------------- build
def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds each build took
    (0.0 for a library that was already there); raises with nvcc's output
    if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            so = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(so, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            so.evt_error_string.argtypes = [ctypes.c_int]
            so.evt_error_string.restype = ctypes.c_char_p
            _libs[name] = so
        return _libs[name]


def call(name: str, fn: str, device: torch.device, *args) -> None:
    """Launch ``fn`` of library ``name`` on ``device``'s current stream and
    raise if the launch was refused."""
    so = lib(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(so, fn)(*args, stream)
    if err != 0:
        msg = so.evt_error_string(err).decode()
        raise RuntimeError(f"{name}.{fn}: CUDA error {err} ({msg})")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of ``tensors``; raises for mixed devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    return dev


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``like``'s if it is a tensor, else CUDA.  Raises when that is CUDA and
    there is none: nothing falls back to the CPU unless asked."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this step runs on CUDA and no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
