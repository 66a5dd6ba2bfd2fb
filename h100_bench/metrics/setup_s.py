"""Set-up: the process's start to the first timed unit of work (host clock)."""


def read(run):
    return run.setup_s
