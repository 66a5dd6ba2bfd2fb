"""Pose crops per second: every slot of every step completed, over the
whole window (host clock)."""
from harness.readers import per_second


def read(run):
    return per_second(run)
