"""Positive edges ranked and folded in, over the whole window's time (host clock)."""


def read(run):
    return sum(b[2] for b in run.batches) / run.window_s
