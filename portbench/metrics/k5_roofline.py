"""K5 (the DyGFormer stack: ``ln_gemm_kernel``, ``gemm_kernel``,
``attention_kernel``): the least time for the stack's FLOPs and bytes over
the batches' real pairs (``counts.stack_work``, bf16 at 989 TFLOP/s) over
the device time of K5's kernels in the traced window, in %."""

import re

from portbench.yard.peaks import bound_s

KERNELS = re.compile(r"\b(ln_gemm_kernel|gemm_kernel|attention_kernel)\b")


def read(run):
    if run.trace is None or not hasattr(run.counts, "stack_work"):
        return None
    dev_s, n = run.trace.kernel_seconds(lambda name: KERNELS.search(name) is not None)
    if n == 0 or dev_s <= 0:
        return None
    least = 0.0
    for sp, i, *_ in run.batches:
        flops, nbytes = run.counts.stack_work(run.cfg, run.sizes[(sp, i)])
        least += bound_s(nbytes, flops, "bf16")
    return 100.0 * least / dev_s
