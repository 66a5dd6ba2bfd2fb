"""The whole training step's share of the bf16 peak (%): three times the
forward's model operations per image at 989 TFLOP/s, over the traced
window."""
import ops_count
from harness.readers import mfu_percent


def read(run):
    return mfu_percent(run, run.units * ops_count.train_ops(run.config) / ops_count.PEAK["bf16"])
