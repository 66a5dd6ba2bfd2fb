"""The whole mixed-task pose step's share of the card's peaks (%): the
least time the peaks allow for the window's model operations
(``ops_count_plus.crop_ops``: int8 linears at 1,979 TOP/s, the rest at
bf16's 989 TFLOP/s, each crop's head at its own K, every slot counted),
over the traced window."""
import ops_count_plus
from harness.readers import mfu_percent


def read(run):
    if not getattr(run, "crops_by_k", None):
        return None
    return mfu_percent(run, ops_count_plus.crops_ops_s(run.config, run.crops_by_k))
