"""The whole pose step's share of the card's peaks (%): the least time the
peaks allow for the window's model operations (``ops_count.serving_ops``:
int8 linears at 1,979 TOP/s, the rest at bf16's 989 TFLOP/s; every slot
counted), over the traced window."""
import ops_count
from harness.readers import mfu_percent


def read(run):
    return mfu_percent(run, run.units * ops_count.ops_s(ops_count.serving_ops(run.config)))
