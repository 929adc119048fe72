"""Base3 link prediction on the port (``examples/linkproppred/base3.py``):
the mean of EdgeBank (fixed window) and t-CoMem, in float32.

    python -m tgm_tpu_torch.examples.linkproppred.base3 [--dataset synthetic]
        [--window-ratio 0.15] [--k 50] [--co-occur 0.8] [--bsize 200] [--device cuda]

Both predictors are built from the train split's edges on ``--device``
(default ``cuda``) and both take each batch's update; val and test then run
as in the EdgeBank example.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from ...nn.modules.edgebank import EdgeBankPredictor
from ...nn.modules.t_comem import tCoMemPredictor
from .._linkpred_common import base_parser, run_baseline, setup_linkpred


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("Base3 (EdgeBank + t-CoMem) link prediction")
    p.add_argument("--window-ratio", type=float, default=0.15)
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--co-occur", type=float, default=0.8)
    return p.parse_args(argv)


def build(args: argparse.Namespace, data=None, cands=None) -> SimpleNamespace:
    """``setup_linkpred``, EdgeBank (fixed) and t-CoMem on its train edges:
    the ctx's ``setup``, ``edgebank``, ``tcomem``, ``score`` and ``update``."""
    setup = setup_linkpred(args, data=data, cands=cands)
    tr, dev = setup.train_dg, setup.device
    eb = EdgeBankPredictor(tr.edge_src, tr.edge_dst, tr.edge_time, memory_mode="fixed",
                           window_ratio=args.window_ratio, device=dev)
    tc = tCoMemPredictor(tr.edge_src, tr.edge_dst, tr.edge_time, num_nodes=setup.num_nodes,
                         k=min(args.k, setup.num_nodes), window_ratio=args.window_ratio,
                         co_occurrence_weight=args.co_occur, device=dev)

    def score(src, dst):
        return (eb(src, dst) + tc(src, dst)) / 2

    def update(src, dst, t):
        eb.update(src, dst, t)
        tc.update(src, dst, t)

    return SimpleNamespace(setup=setup, edgebank=eb, tcomem=tc, score=score, update=update)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    ctx = build(args)
    return dict(run_baseline(ctx.setup, ctx.score, ctx.update), ctx=ctx)


if __name__ == "__main__":
    main()
