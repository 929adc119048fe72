"""95th percentile, over all the window's batches, of the interval between
consecutive batch-completion CUDA events (a pass's first batch from the
event after its snapshot restore)."""

import numpy as np


def read(run):
    if not run.intervals_ms:
        return None
    return float(np.percentile(np.asarray(run.intervals_ms, dtype=np.float64), 95))
