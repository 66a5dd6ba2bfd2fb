"""Host milliseconds to queue one mixed-task ``pose_step`` call, no sync:
the median of the traced run's untraced calls before its window (the
ordering by task and the group table's upload included)."""
import statistics


def read(run):
    if not run.enqueue_s:
        return None
    return 1e3 * statistics.median(run.enqueue_s)
