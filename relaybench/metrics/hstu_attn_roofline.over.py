"""The dense attention kernel's (causal prefill; a full rank's dense rank
too) share of its roofline over the window, in %."""

from relaybench import readers


def read(run):
    return readers.roofline(run, paged=False)
