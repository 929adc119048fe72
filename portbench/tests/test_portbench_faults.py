"""The harness with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have (one card: no exchange between chips
to leave out). The look for a card is skipped: the cells run on the CPU
at tiny size."""

import pytest
import torch

import tgm_tpu_torch.hooks.neighbors as neighbors
import tgm_tpu_torch.train.programs as programs
from tgm_tpu_torch.nn.decoder import decoders
from portbench import run

CELLS = ["tgn-wiki.tgb-q999", "dygformer-wiki.tgb-q20"]


def _state_unchanged(mp, workload):
    """The step returns its state unchanged: TGN's memory commit, or (the
    DyGFormer cell's only state) the recency push, does nothing."""
    if workload.startswith("tgn"):
        mp.setattr(programs, "tgn_eval_commit", lambda memory, state, batch, n: state)
    else:
        mp.setattr(neighbors, "recency_update", lambda state, *a, **k: state)


def _half_batch(mp, workload):
    """Half of each batch left out, the mean over the rest."""
    orig = programs.mrr_sum_count

    def half(pos, neg, neg_valid=None, edge_valid=None):
        keep = torch.arange(pos.shape[0], device=pos.device) < pos.shape[0] // 2
        return orig(pos, neg, neg_valid, edge_valid & keep)

    mp.setattr(programs, "mrr_sum_count", half)


def _answer_altered(mp, workload):
    """One score changed where the decoder produces it."""
    orig = decoders.LinkPredictor.forward

    def altered(self, z_src, z_dst):
        out = orig(self, z_src, z_dst).clone()
        out[out.shape[0] // 2] += 0.25 * (out.abs().max() + 1.0)
        return out

    mp.setattr(decoders.LinkPredictor, "forward", altered)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    tmp, bench = tiny_root
    cell = run.Cell(bench, workload, root=tmp, base=tmp / "portbench")
    fault(monkeypatch, workload)
    res = run.run_cell(cell, 21, 0.3, trace=False, device=torch.device("cpu"))
    assert not res["correct"], res["compared"]
