"""K1 (the fused recency select, ``recency_select_eid_kernel``): the least
time for the bytes the batches' real seeds select (``counts.k1_bytes``:
each input read once, each output written once, at 3.35 TB/s) over the
device time of K1's kernels in the traced window, in %."""

from portbench.yard.peaks import bound_s

KERNELS = ("recency_select_eid_kernel",)


def read(run):
    if run.trace is None or not hasattr(run.counts, "k1_bytes"):
        return None
    dev_s, n = run.trace.kernel_seconds(lambda name: any(k in name for k in KERNELS))
    if n == 0 or dev_s <= 0:
        return None
    least = sum(bound_s(run.counts.k1_bytes(run.cfg, run.sizes[(sp, i)]), 0.0)
                for sp, i, *_ in run.batches)
    return 100.0 * least / dev_s
