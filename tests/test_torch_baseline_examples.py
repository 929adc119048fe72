"""The baseline examples and scripts against the JAX examples' own ``main``.

Each JAX example (``examples/linkproppred/{edgebank,poptrack,base3}.py``
and the ``tgb_seq``, ``thgl`` and ``tkgl`` EdgeBank scripts) runs its
``main`` on ``synthetic-200-3000`` (its val and test candidates, batches
of 200) with its ``mrr_per_edge`` name replaced by a recorder of the
scores and reciprocal ranks; the port's counterpart runs its ``main`` on
the CPU with ``_linkpred_common.baseline_batch`` wrapped to record its
scores. Per-edge reciprocal ranks must be equal, except on near-tie edges:
a valid candidate that ties its positive in one package only, or lies
within one float32 ulp of it (t-CoMem sums in fp64 and casts; a last-bit
difference can merge two scores into a tie in one package only). Those are counted and
printed; for EdgeBank and PopTrack, whose scores are exact, none is
allowed. The JAX package computes its reciprocal ranks in fp64 and the
port in float32, so they compare after a cast to float32. Val and test MRR
agree within 1e-6.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from tgm_tpu_torch.examples import _linkpred_common as common
from tgm_tpu_torch.hooks import (
    TGBNegativeEdgeSamplerHook,
    TGBTHGNegativeEdgeSamplerHook,
    TGBTKGNegativeEdgeSamplerHook,
)

DATASET, BSIZE = "synthetic-200-3000", 200

# (port module, JAX module, module holding the JAX scoring loop, flags, exact, hook class)
CASES = {
    "edgebank-unlimited": ("edgebank", "edgebank", "edgebank", [], True, TGBNegativeEdgeSamplerHook),
    "edgebank-fixed": ("edgebank", "edgebank", "edgebank", ["--memory-mode", "fixed"], True,
                       TGBNegativeEdgeSamplerHook),
    "poptrack": ("poptrack", "poptrack", "poptrack", ["--k", "20", "--decay", "0.8"], True,
                 TGBNegativeEdgeSamplerHook),
    "base3": ("base3", "base3", "base3", [], False, TGBNegativeEdgeSamplerHook),
    "base3-k5": ("base3", "base3", "base3", ["--k", "5", "--window-ratio", "0.5",
                                              "--co-occur", "0.3"], False,
                 TGBNegativeEdgeSamplerHook),
    "tgb_seq": ("tgb_seq.edgebank", "tgb_seq.edgebank", "edgebank", [], True,
                TGBNegativeEdgeSamplerHook),
    "thgl": ("thgl.edgebank", "thgl.edgebank", "edgebank", ["--memory-mode", "fixed"], True,
             TGBTHGNegativeEdgeSamplerHook),
    "tkgl": ("tkgl.edgebank", "tkgl.edgebank", "edgebank", [], True,
             TGBTKGNegativeEdgeSamplerHook),
}


def run_jax(monkeypatch, jmod_name, loop_name, flags):
    """The JAX script's ``main``; returns each call's (pos, neg, neg_valid, rr)."""
    loop = importlib.import_module(f"examples.linkproppred.{loop_name}")
    jmod = importlib.import_module(f"examples.linkproppred.{jmod_name}")
    # The JAX scripts replace names in the EdgeBank example; put them back after.
    for name in ("load_dataset", "TGBNegativeEdgeSamplerHook"):
        if hasattr(loop, name):
            monkeypatch.setattr(loop, name, getattr(loop, name))
    rec, orig = [], loop.mrr_per_edge

    def mrr_per_edge(pos, neg, neg_valid=None):
        rr = orig(pos, neg, neg_valid=neg_valid)
        rec.append(tuple(np.asarray(x) for x in (pos, neg, neg_valid, rr)))
        return rr

    monkeypatch.setattr(loop, "mrr_per_edge", mrr_per_edge)
    monkeypatch.setattr(sys, "argv", ["prog", "--dataset", DATASET, "--bsize", str(BSIZE), *flags])
    jmod.main()
    return rec


def run_port(monkeypatch, mod_name, flags):
    """The port's script ``main`` on the CPU; returns its result and each
    batch's scores (positives then candidates)."""
    mod = importlib.import_module(f"tgm_tpu_torch.examples.linkproppred.{mod_name}")
    rec, orig = [], common.baseline_batch

    def baseline_batch(score, update):
        def recorded(src, dst):
            s = score(src, dst)
            rec.append(s.clone())
            return s

        return orig(recorded, update)

    monkeypatch.setattr(common, "baseline_batch", baseline_batch)
    out = mod.main(["--dataset", DATASET, "--bsize", str(BSIZE), "--device", "cpu", *flags])
    return out, rec


def near_ties(p_pos, p_neg, j_pos, j_neg, valid):
    """Edges with a valid candidate that ties its positive in one package
    only, or lies within one float32 ulp of it without tying in either."""
    def gaps(pos, neg):
        return np.abs(neg - pos[:, None]), np.spacing(np.abs(pos).astype(np.float32))[:, None]

    (gp, up), (gj, uj) = gaps(p_pos, p_neg), gaps(j_pos, j_neg)
    near = ((gp > 0) & (gp <= up)) | ((gj > 0) & (gj <= uj)) | ((gp == 0) != (gj == 0))
    return (near & valid).any(1)


@pytest.mark.parametrize("case", list(CASES))
def test_script_matches_the_jax_example(monkeypatch, case):
    mod_name, jmod_name, loop_name, flags, exact, hook_cls = CASES[case]
    out, p_rec = run_port(monkeypatch, mod_name, flags)
    setup = out["ctx"].setup
    assert type(setup.neg_hooks["val"]) is hook_cls
    j_rec = run_jax(monkeypatch, jmod_name, loop_name, flags)
    assert len(j_rec) == len(p_rec)

    first = 0
    for split in ("val", "test"):
        n = setup.streams[split].num_edges
        nb = setup.streams[split].num_batches
        j = [np.concatenate(c)[:n] for c in zip(*j_rec[first : first + nb])]
        j_pos, j_neg, j_valid, j_rr = j
        scores = torch.stack(p_rec[first : first + nb]).numpy()
        Q = j_neg.shape[1]
        p_pos = scores[:, :BSIZE].reshape(-1)[:n]
        p_neg = scores[:, BSIZE:].reshape(-1, Q)[:n]
        first += nb

        rr = out[f"{split}_rr"].numpy()
        assert rr.shape == (n,)
        differ = rr != j_rr.astype(np.float32)  # the JAX package's ranks are fp64
        ties = near_ties(p_pos, p_neg, j_pos, j_neg, j_valid)
        if exact:
            np.testing.assert_array_equal(p_pos, j_pos)
            np.testing.assert_array_equal(p_neg, j_neg)
            assert not differ.any()
        else:
            tol = 1e-6 * max(float(np.abs(j_neg).max()), float(np.abs(j_pos).max()), 1.0)
            assert float(np.abs(p_pos - j_pos).max()) <= tol
            assert float(np.abs(np.where(j_valid, p_neg - j_neg, 0)).max()) <= tol
            assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)
        print(f"{case} {split}: {n} edges, {int(ties.sum())} near-tie edges, "
              f"{int(differ.sum())} ranks differ")
        j_mrr = float(j_rr.mean())
        assert abs(out[f"{split}_mrr"] - j_mrr) <= 1e-6, (out[f"{split}_mrr"], j_mrr)
