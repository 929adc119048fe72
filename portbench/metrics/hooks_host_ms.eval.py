"""Host ms a batch outside the step span: the stream's ``batch_at`` and
the key's hook DAG, including their waits for the card."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b[4] - b[3] for b in run.batches) / len(run.batches)
