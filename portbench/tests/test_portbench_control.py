"""Each control (the reference with one part a precision step down, in the
program's place) fails the cell's limits, at tiny size on three seeds."""

import pytest
import torch

from portbench import control, run
from portbench.yard import checks


@pytest.mark.parametrize("workload", ["tgn-wiki.tgb-q999", "dygformer-wiki.tgb-q20"])
def test_control_is_not_correct(tiny_root, workload):
    tmp, bench = tiny_root
    cell = run.Cell(bench, workload, root=tmp, base=tmp / "portbench")
    for seed in (1, 2, 3):
        for fmt, numbers in control.control_numbers(cell, seed, torch.device("cpu")).items():
            ok, compared = checks.verdict(numbers, cell.limits)
            assert not ok, (fmt, compared)
