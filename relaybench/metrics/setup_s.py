"""From process start to the first due arrival, compiles included."""


def read(run):
    return run.setup_s
