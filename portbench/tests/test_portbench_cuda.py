"""On the card: each cell runs briefly and comes out correct."""

import json
import subprocess
import sys

import pytest

from tiny import HERE


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tgn-wiki.tgb-q999", "dygformer-wiki.tgb-q20"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
