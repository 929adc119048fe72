"""The benchmark's clock around folding the train split into the state."""


def read(run):
    return run.fold_s
