"""The program's link-prediction set-up, shared by the configurations: the
stream as ``tgm_tpu_torch`` data, the ``DeviceEdgeStream`` of each split and
a ``HookManager`` as the port's examples build it (a TGB candidate hook per
evaluated split, the shared ``RecencyNeighborHook`` over [src | dst |
candidates]); the train key serves one PAD candidate per edge, so that
folding the train split through the eval route only advances the state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from tgm_tpu_torch import DGData
from tgm_tpu_torch.core.graph import DGraph
from tgm_tpu_torch.data.split import TemporalSplit
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TGBNegativeEdgeSamplerHook
from tgm_tpu_torch.train import DeviceEdgeStream

from .seeds import derive
from .stream import Stream

SPLITS = ("train", "val", "test")


@dataclass
class LinkPredSetup:
    data: DGData
    dgs: Dict[str, DGraph]
    streams: Dict[str, DeviceEdgeStream]
    hm: HookManager
    recency: RecencyNeighborHook
    tgb_hooks: Dict[str, TGBNegativeEdgeSamplerHook]

    def recency_state(self) -> List[torch.Tensor]:
        return list(self.recency.state)


def build(s: Stream, cands: Dict[str, np.ndarray], batch_size: int, num_nbrs: int,
          eid_layout: bool, seed: int, device: torch.device) -> LinkPredSetup:
    data = DGData.from_raw(s.t, np.stack([s.src, s.dst], 1), s.edge_x, time_delta="s")
    val_time, test_time = (int(s.t[s.bounds[k][0]]) for k in ("val", "test"))
    dgs = dict(zip(SPLITS, (DGraph(d) for d in data.split(TemporalSplit(val_time, test_time)))))
    streams = {k: DeviceEdgeStream(dg, batch_size, device=device) for k, dg in dgs.items()}
    hm = HookManager(keys=list(SPLITS))
    pad = np.full((dgs["train"].num_edge_events, 1), -1, dtype=np.int32)
    tgb = {}
    for split, table in (("train", pad), ("val", cands["val"]), ("test", cands["test"])):
        tgb[split] = TGBNegativeEdgeSamplerHook(table, device=device,
                                                seed=derive(seed, f"{split}_times"))
        hm.register(split, tgb[split])
    rec = RecencyNeighborHook(
        s.num_nodes, [num_nbrs], ["edge_src", "edge_dst", "neg"],
        ["edge_time", "edge_time", "neg_time"], edge_dim=s.edge_x.shape[1],
        edge_x_full=data.edge_x if eid_layout else None, device=device)
    hm.register_shared(rec)
    return LinkPredSetup(data=data, dgs=dgs, streams=streams, hm=hm, recency=rec, tgb_hooks=tgb)
