"""Share of the traced pose window with no operation on the card (%); the
profiler's own host cost is inside it."""
from harness.readers import idle_percent


def read(run):
    return idle_percent(run)
