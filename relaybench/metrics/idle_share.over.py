"""Share of the traced window with no kernel running, in %."""

from relaybench import readers


def read(run):
    return readers.idle_share(run)
