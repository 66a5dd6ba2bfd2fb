"""The native (C++) host tier: greedy IoU NMS on the host, ctypes-bound.

Port of ``easy_vitpose_tpu/native/``.  ``nms.cpp`` is built at first use
with the host C++ compiler (``$CXX``, else ``g++``) into the kernels'
build directory, ``easy_vitpose_tpu_torch/_build``, named by a digest of
the source and the flags, so an edited source is rebuilt.  A build that
fails raises with the compiler's output: unlike JAX's ``nms_cpu`` there is
no silent numpy route.  :func:`..ops.oks.bbox_nms` is the routine's plain
version.  Host code: no device path calls it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nms.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    from ..kernels import BUILD_DIR
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libnms_host-{h}.so"


def build() -> Path:
    """Compile ``nms.cpp`` if it is not built yet; raises if the compiler
    is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler found (set CXX) to build native/nms.cpp")
    out.parent.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building native/nms.cpp failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.nms_cpu.restype = ctypes.c_int
            lib.nms_cpu.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                    ctypes.c_float, ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the compiled host NMS is loaded, building it first if it is
    not built yet: what :func:`nms_cpu` runs.  False where no compiler can
    build it (``nms_cpu`` then raises)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def nms_cpu(dets: np.ndarray, thr: float) -> List[int]:
    """Greedy IoU NMS over [x1, y1, x2, y2, score] rows: the kept row
    indices, highest score first (ties in row order)."""
    dets = np.ascontiguousarray(dets, np.float32).reshape(-1, 5)
    lib = _load()
    keep = np.zeros(len(dets), np.int32)
    kept = lib.nms_cpu(dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(dets),
                       ctypes.c_float(thr), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:kept].tolist()
