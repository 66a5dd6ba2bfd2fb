"""Process-aware logging (reference vit_utils/logging.py:9-132).

Port of ``easy_vitpose_tpu/utils/logging.py``.  The main process (rank 0,
or no process group: ``parallel/mesh.py::is_main_process``) gets a
StreamHandler at the asked level plus an optional FileHandler; other ranks
log only errors, as the reference's torch.distributed rank gating does.
"""
from __future__ import annotations

import functools
import logging
from typing import Optional

from ..parallel.mesh import is_main_process

_initialized = set()


def get_logger(name: str = "easy_vitpose_tpu_torch",
               log_file: Optional[str] = None,
               log_level: int = logging.INFO) -> logging.Logger:
    """The logger ``name``, given its handlers on the first call in this
    process (later calls return it as it is)."""
    logger = logging.getLogger(name)
    if name in _initialized:
        return logger
    main = is_main_process()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if main and log_file is not None:
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(log_level if main else logging.ERROR)
    logger.propagate = False
    _initialized.add(name)
    return logger


def print_log(msg, logger=None, level: int = logging.INFO):
    """print / logger / 'silent' dispatch (reference logging.py:85-111)."""
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == "silent":
        pass
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        raise TypeError(f"invalid logger {logger!r}")


def master_only(fn):
    """Run only on the main process; other ranks get None (reference
    dist_util.py:130-138)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
    return wrapper
