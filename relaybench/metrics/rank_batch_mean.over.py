"""Mean requests a rank launch in the window (the batchers' stats)."""

from relaybench import readers


def read(run):
    return readers.batch_mean(run)
