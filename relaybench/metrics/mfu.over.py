"""Model FLOPs of the window's pre-infers and ranks over its seconds, over
the card's peak, in %."""

from relaybench import readers


def read(run):
    return readers.mfu(run)
