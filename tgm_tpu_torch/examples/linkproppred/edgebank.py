"""EdgeBank link prediction on the port (``examples/linkproppred/edgebank.py``).

    python -m tgm_tpu_torch.examples.linkproppred.edgebank [--dataset synthetic]
        [--memory-mode unlimited|fixed] [--window-ratio 0.15] [--bsize 200] [--device cuda]

EdgeBank's memory is built from the train split's edges on ``--device``
(default ``cuda``); then val and test stream through their TGB candidate
hooks (``_linkpred_common.run_baseline``): each batch scores its positives
and their candidates on the device, takes each edge's reciprocal rank and
stores the batch's edges. ``main`` takes the dataset loader and the
candidate hook class, which the ``tgb_seq``, ``thgl`` and ``tkgl`` scripts
replace.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

from ...hooks import TGBNegativeEdgeSamplerHook
from ...nn.modules.edgebank import EdgeBankPredictor
from .._datasets import load_dataset
from .._linkpred_common import base_parser, run_baseline, setup_linkpred


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("EdgeBank link prediction")
    p.add_argument("--memory-mode", type=str, default="unlimited", choices=["unlimited", "fixed"])
    p.add_argument("--window-ratio", type=float, default=0.15)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None, load: Callable = load_dataset,
          neg_hook: type = TGBNegativeEdgeSamplerHook) -> SimpleNamespace:
    """``setup_linkpred`` (``data`` and ``cands``, or ``load``, and
    ``neg_hook``) and EdgeBank on its train edges: the ctx's ``setup``,
    ``model``, ``score`` and ``update``."""
    setup = setup_linkpred(args, data=data, cands=cands, load=load, neg_hook=neg_hook)
    tr = setup.train_dg
    model = EdgeBankPredictor(tr.edge_src, tr.edge_dst, tr.edge_time, memory_mode=args.memory_mode,
                              window_ratio=args.window_ratio, device=setup.device)
    return SimpleNamespace(setup=setup, model=model, score=model, update=model.update)


def main(argv: Optional[List[str]] = None, load: Callable = load_dataset,
         neg_hook: type = TGBNegativeEdgeSamplerHook) -> Dict[str, Any]:
    """EdgeBank on the train edges of the dataset ``load`` gives, then val
    and test against ``neg_hook``'s candidates; returns what
    ``run_baseline`` returns, with the ctx under ``"ctx"``."""
    args = parse_args(argv)
    ctx = build(args, load=load, neg_hook=neg_hook)
    return dict(run_baseline(ctx.setup, ctx.score, ctx.update), ctx=ctx)


if __name__ == "__main__":
    main()
