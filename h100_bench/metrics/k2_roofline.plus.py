"""K2 at ViTPose+-H (``models/quant.py`` with the routed fc2 of
``models/moe.py``) against its bound (%): the bound of its blocks over the
window (``ops_count.k2_block``: a token's fc2 gives D columns, the shared
and the expert rows together) over the device time of its launches:
LayerNorm, row quantisation, the dense and the grouped int8 GEMMs and the
attention, found by kernel name."""
import ops_count
from harness.readers import roofline_percent

K2_KERNELS = ("layernorm_kernel", "rowquant_kernel", "gemm_kernel", "grouped_gemm_kernel",
              "fwd_kernel")


def read(run):
    c, slots = run.config, run.traffic["slots"]
    bound = ops_count.bound_s(*ops_count.k2_block(c, slots)) * c["depth"] * run.steps
    return roofline_percent(run, bound, K2_KERNELS)
