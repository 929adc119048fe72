"""PopTrack link prediction on the port (``examples/linkproppred/poptrack.py``).

    python -m tgm_tpu_torch.examples.linkproppred.poptrack [--dataset synthetic]
        [--k 50] [--decay 0.9] [--bsize 200] [--device cuda]

The popularity is built from the train split's edges on ``--device``
(default ``cuda``); val and test then run as in the EdgeBank example.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from ...nn.modules.poptrack import PopTrackPredictor
from .._linkpred_common import base_parser, run_baseline, setup_linkpred


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("PopTrack link prediction")
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--decay", type=float, default=0.9)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """``setup_linkpred`` and PopTrack on its train edges: the ctx's
    ``setup``, ``model``, ``score`` and ``update``."""
    setup = setup_linkpred(args, data=data, cands=cands)
    tr = setup.train_dg
    model = PopTrackPredictor(tr.edge_src, tr.edge_dst, tr.edge_time, num_nodes=setup.num_nodes,
                              k=min(args.k, setup.num_nodes), decay=args.decay,
                              device=setup.device)
    return SimpleNamespace(setup=setup, model=model, score=model, update=model.update)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    ctx = build(args)
    return dict(run_baseline(ctx.setup, ctx.score, ctx.update), ctx=ctx)


if __name__ == "__main__":
    main()
