"""The optimizer (``train/fused_opt.py``: the norm kernel and K9) against
its bytes bound (%): 20 B per parameter a step (``ops_count.adam_q8_bytes``)
over their device time."""
import ops_count
from harness.readers import roofline_percent

OPT_KERNELS = ("grad_norm_kernel", "adam_q8_table_kernel")


def read(run):
    bound = ops_count.adam_q8_bytes(run.params) / ops_count.PEAK["hbm"] * run.steps
    return roofline_percent(run, bound, OPT_KERNELS)
