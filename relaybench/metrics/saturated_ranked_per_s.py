"""Requests whose scores reached the sink inside the window, over its
seconds."""


def read(run):
    n = sum(q["done"] is not None and q["done"] < run.t_close
            for q in run.requests)
    return n / run.seconds
