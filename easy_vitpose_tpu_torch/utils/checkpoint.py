"""The JAX package's ``.npz`` parameter format, with numpy only.

Port of ``easy_vitpose_tpu/utils/checkpoint.py``: a params tree of nested
dicts and lists is stored flat, keyed by its '/'-joined path.  Both the
ViTPose params (``convert.from_jax.state_dict_from_jax`` turns them into the
port's state dict) and the YOLO params (``detect.yolo.yolo_params_from_jax``,
with a ``__meta__`` entry) are kept this way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists of arrays -> {"a/b/0/c": array}."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return {prefix: np.asarray(params)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def save_params(path: str, params) -> None:
    np.savez_compressed(path, **flatten_params(params))


def load_params(path: str) -> Any:
    """Rebuild the nested dict/list tree from a flat npz."""
    z = np.load(path)
    root: Dict[str, Any] = {}
    for key in z.files:
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return _listify(root)


def _listify(node, path=()):
    """Convert {'0': ..., '1': ...} dicts (from list indices) back to lists —
    only for contiguous 0..n-1 index sets, and never for the YOLO 'model'
    layer table whose keys are layer numbers with gaps (0..22 minus pass-
    through layers)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v, path + (k,)) for k, v in node.items()}
    is_model_table = path and path[-1] == "model"
    if (out and not is_model_table
            and set(out) == {str(i) for i in range(len(out))}):
        return [out[str(i)] for i in range(len(out))]
    return out
