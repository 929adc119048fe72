"""The model FLOPs the window's batches need, from the configuration's
widths and each batch's real sizes (``counts.model_flops``), as the least
time at the configuration's peaks, over the window's time, in %."""

from portbench.yard.peaks import FLOPS_PER_S


def read(run):
    least = 0.0
    for split, i, *_ in run.batches:
        for fmt, f in run.counts.model_flops(run.cfg, run.sizes[(split, i)]).items():
            least += f / FLOPS_PER_S[fmt]
    return 100.0 * least / run.window_s if least > 0 else None
