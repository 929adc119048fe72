"""Host ms a batch inside the step span (the model's eval core)."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b[5] - b[4] for b in run.batches) / len(run.batches)
