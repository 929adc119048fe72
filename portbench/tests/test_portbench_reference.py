"""The plain references against tgm_tpu_torch on the CPU, at tiny sizes:
hook products, state, scores and MRR sums, through the harness's run."""

import pytest
import torch

from portbench import run

CELLS = ["tgn-wiki.tgb-q999", "dygformer-wiki.tgb-q20"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**33 + 11])
def test_reference_agrees_with_the_port(tiny_root, workload, seed):
    tmp, bench = tiny_root
    cell = run.Cell(bench, workload, root=tmp, base=tmp / "portbench")
    res = run.run_cell(cell, seed, 0.5, trace=False, device=torch.device("cpu"))
    c = res["compared"]
    assert res["correct"], c
    assert c["hook_mismatch"]["value"] == 0 and c["state_mismatch"]["value"] == 0
    assert c["count_mismatch"]["value"] == 0 and c["mrr_outside_band"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0
    if workload.startswith("tgn"):
        # fp32 on both sides: the gaps are rounding.
        assert c["score_gap"]["value"] < 1e-5 and c["state_gap"]["value"] < 1e-5


def test_traced_run_reads_the_host_metrics(tiny_root):
    tmp, bench = tiny_root
    cell = run.Cell(bench, CELLS[0], root=tmp, base=tmp / "portbench")
    res = run.run_cell(cell, 5, 0.3, trace=True, device=torch.device("cpu"))
    m = res["metrics"]
    # The device metrics read nothing without a card, and are left out.
    assert {"hooks_host_ms.eval", "step_host_ms.eval", "mfu.eval", "setup.fold_s"} <= set(m)
    assert not {"k1_roofline", "device_idle.eval", "launches_per_batch.eval"} & set(m)
    assert "eval_edges_per_s" not in m
