"""Share of the traced window with no kernel, copy or set on the card, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (run.trace.window_s - run.trace.busy_s) / run.trace.window_s
