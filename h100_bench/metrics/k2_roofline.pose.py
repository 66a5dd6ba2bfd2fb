"""K2, the int8 block (``models/quant.py``), against its bound (%): the
bound of its blocks over the window (``ops_count.k2_block``) over the device
time of its launches: LayerNorm, row quantisation, the int8 GEMM and the
attention, found by kernel name."""
import ops_count
from harness.readers import roofline_percent

K2_KERNELS = ("layernorm_kernel", "rowquant_kernel", "gemm_kernel", "fwd_kernel")


def read(run):
    c, slots = run.config, run.traffic["slots"]
    bound = ops_count.bound_s(*ops_count.k2_block(c, slots)) * c["depth"] * run.steps
    return roofline_percent(run, bound, K2_KERNELS)
