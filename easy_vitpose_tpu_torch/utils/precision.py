"""Float32, reproducible convolutions where the computation is float32.

PyTorch runs a float32 convolution through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, and that flag is True by
default; TF32 keeps about three decimal digits.  cuDNN may also pick an
algorithm that sums with atomics (the head's transposed convolutions at
float32 do), so that two runs of the same frame differ in their last bits.
The fp32 serving path is the parity mode, held to float32 (1e-5) and, like
every other serving path of the port, to the same bits for the same inputs
(a CUDA graph's replay against its eager program), so its convolutions (the
head's, the hybrid stem's and the detector's) run inside
:func:`float32_convolutions`, whatever the caller's process has set.  The
flags are read by cuDNN when an operation is dispatched, so the scope holds
for eager calls and for a CUDA graph captured inside it.  bf16 and int8
paths are untouched.

The fp32 block's GEMMs and attention keep float32 accuracy on the TF32
tensor cores by splitting each operand into two TF32 numbers
(``models/fused_block.py``); :func:`tf32_check_floats` are the float32
patterns that the split is checked on, on the CPU and on the card.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# float32 bit patterns that exercise a round-to-TF32 split: ties (low 13
# bits exactly 0x1000) and their neighbours, carries into the exponent and
# into infinity, subnormals (one carrying into the smallest normal), signed
# zeros, infinities and NaNs (quiet, signalling, negative)
TF32_SPECIAL_BITS = (
    0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x3F803000, 0xBF803000,   # ties, neighbours
    0x3FFFF000, 0xBFFFF000, 0x3FFFEFFF,                                       # carry into exponent
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FEFFF, 0x7F7FF000,                           # near the largest
    0x00000001, 0x00001000, 0x00000FFF, 0x00003000, 0x007FFFFF, 0x807FF000,   # subnormals
    0x80001000, 0x00800000, 0x00801000,                                       # smallest normal
    0x00000000, 0x80000000,                                                   # signed zeros
    0x7F800000, 0xFF800000,                                                   # infinities
    0x7FC00000, 0x7F800001, 0xFFFFFFFF, 0x7FBFF000,                           # NaNs
)


def tf32_check_floats(seed: int = 0, n_random: int = 4096) -> np.ndarray:
    """:data:`TF32_SPECIAL_BITS`, then random float32 values with exponents
    from 2^-120 to 2^120 and every low-bit pattern (a quarter of them made
    ties), as float32."""
    g = np.random.default_rng(seed)
    rnd = (g.uniform(-1, 1, n_random) * np.exp2(g.integers(-120, 120, n_random)))
    bits = rnd.astype(np.float32).view(np.uint32)
    bits[: n_random // 4] = (bits[: n_random // 4] & 0xFFFFE000) | 0x1000   # more ties
    return np.concatenate([np.array(TF32_SPECIAL_BITS, np.uint32), bits]).view(np.float32)


@contextlib.contextmanager
def float32_convolutions(dtype: torch.dtype):
    """cuDNN's TF32 off and its deterministic algorithms on for the
    duration, when ``dtype`` is float32; the caller's settings are
    restored after."""
    if dtype != torch.float32:
        yield
        return
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev
