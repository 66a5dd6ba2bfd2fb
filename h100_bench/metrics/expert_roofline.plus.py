"""The routed expert product of ViTPose+'s fc2 (``grouped_gemm_kernel``,
``csrc/gemm_q8.cuh``) against its bound (%): for each block of each step of
the window, the bound of the rows it routed and the experts they met
(``ops_count_plus.expert_gemm``: ``2 rows 5120 320`` int8 operations at
ViT-H; bytes of the int8 rows, the experts' int8 weights and the output
columns), over the kernel's device time, found by name."""
import ops_count
import ops_count_plus
from harness.readers import roofline_percent


def read(run):
    c = getattr(run, "config", None)
    if not getattr(run, "experts_per_step", None) or not run.counters.get("rows"):
        return None
    rows = run.counters["rows"] // (c["depth"] * run.steps)       # a block's rows a step
    bound = sum(ops_count.bound_s(*ops_count_plus.expert_gemm(c, rows, n))
                for n in run.experts_per_step) * c["depth"]
    return roofline_percent(run, bound, ("grouped_gemm_kernel",))
