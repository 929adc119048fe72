"""Seconds from the process's start to the window's: imports, the stream,
the candidate tables and the weights made from the seed, the kernels'
build and load, the fold of the train split, the snapshot, the warm-up."""


def read(run):
    return run.setup_s
