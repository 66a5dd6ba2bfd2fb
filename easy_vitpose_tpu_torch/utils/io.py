"""Video / image IO helpers (reference vit_utils/inference.py:13-94).

VideoReader additionally supports background prefetch (a decode thread ahead
of the compute loop) so host video decode overlaps device compute — the
double-buffering the reference lists as TODO (README.md:320-328).

The port's own copy of the parts of ``easy_vitpose_tpu/utils/io.py`` that
``cli/infer.py`` uses; cv2 is an optional import (media input needs it).
"""
from __future__ import annotations

import json
import queue
import threading
from typing import Iterator, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

ROTATION_MAP = {0: None, 90: "ccw", 180: "r180", 270: "cw"}


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder accepting numpy arrays/scalars (reference :13-17)."""

    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        return super().default(obj)


def _rotate(img: np.ndarray, rotate: Optional[str]) -> np.ndarray:
    if rotate is None:
        return img
    code = {"ccw": cv2.ROTATE_90_COUNTERCLOCKWISE,
            "r180": cv2.ROTATE_180,
            "cw": cv2.ROTATE_90_CLOCKWISE}[rotate]
    return cv2.rotate(img, code)


class VideoReader:
    """Iterates RGB frames from a file or webcam index, with optional rotation
    and a prefetch thread (depth ``prefetch`` frames)."""

    def __init__(self, file_name, rotate: int = 0, prefetch: int = 2):
        self.file_name = file_name
        self.rotate = ROTATION_MAP[rotate]
        self.prefetch = prefetch
        try:  # OpenCV needs int to read from webcam
            self.file_name = int(file_name)
        except (ValueError, TypeError):
            pass

    def __iter__(self) -> Iterator[np.ndarray]:
        cap = cv2.VideoCapture(self.file_name)
        if not cap.isOpened():
            raise IOError(f"Video {self.file_name} cannot be opened")
        if self.prefetch <= 0:
            return self._read_sync(cap)
        return self._read_prefetch(cap)

    def _read_sync(self, cap):
        while True:
            ok, img = cap.read()
            if not ok:
                cap.release()
                return
            img = _rotate(img, self.rotate)
            yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _read_prefetch(self, cap):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()

        def worker():
            while True:
                ok, img = cap.read()
                if not ok:
                    q.put(SENTINEL)
                    cap.release()
                    return
                img = _rotate(img, self.rotate)
                q.put(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                return
            yield item


def video_metadata(path) -> dict:
    cap = cv2.VideoCapture(path)
    meta = {
        "fps": cap.get(cv2.CAP_PROP_FPS),
        "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
    }
    cap.release()
    return meta
