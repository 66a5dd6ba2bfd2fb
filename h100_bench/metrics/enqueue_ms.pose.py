"""Host milliseconds to queue one ``pose_step`` call, no sync: the median
of the traced run's untraced calls before its window (the profiler's own
cost per operation would otherwise be most of it)."""
import statistics


def read(run):
    if not run.enqueue_s:
        return None
    return 1e3 * statistics.median(run.enqueue_s)
