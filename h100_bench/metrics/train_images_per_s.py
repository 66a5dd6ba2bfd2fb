"""Training images per second: every image of every step, over the whole
window, which ends when the last queued step has finished (host clock)."""
from harness.readers import per_second


def read(run):
    return per_second(run)
