"""Device kernels launched a batch in the traced window, from the profiler."""


def read(run):
    if run.trace is None or not run.batches:
        return None
    return sum(run.trace.launches.values()) / len(run.batches)
