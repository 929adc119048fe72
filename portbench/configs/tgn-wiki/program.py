"""The program under test for ``tgn-wiki``: TGN eval as the port's
``examples/linkproppred/tgn.py`` runs it, rowwise encoder, eid-layout
recency (K1 fused), the push and the store commit.

The eval core is ``build_tgn_hook_cores(..., style="rowwise")[1]``. The
fold of the train split goes through the same core (one PAD candidate per
edge), which stores each batch's messages and applies them, as in eval.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tgm_tpu_torch.nn import GraphAttentionEmbeddingRowwise, LinkPredictor, TGNMemory
from tgm_tpu_torch.train import build_tgn_hook_cores, hook_epoch

from portbench.yard import evalcell, linkpred, weights
from portbench.yard.checks import ring_canonical
from portbench.yard.window import Capture


def run_cell(cell, seed, seconds, trace, device, t_process, warm_batches=4):
    """One run of a cell of this configuration: TGB's eval protocol."""
    return evalcell.run(Program, cell, seed, seconds, trace, device, t_process, warm_batches)


def build_modules(cfg, num_nodes: int) -> Dict[str, torch.nn.Module]:
    D, M, E, T = cfg["edge_dim"], cfg["memory_dim"], cfg["embedding_dim"], cfg["time_dim"]
    return {
        "memory": TGNMemory(num_nodes, D, M, T),
        "encoder": GraphAttentionEmbeddingRowwise(M, E, D, T, n_heads=cfg["num_heads"],
                                                  dropout=0.0),
        "decoder": LinkPredictor(node_dim=E, hidden_dim=cfg["decoder_hidden"],
                                 nlayers=cfg["decoder_layers"]),
    }


def weight_shapes(cfg):
    """The weights' names and shapes, and a maker of the inputs that are
    not parameters (none here)."""
    return weights.shapes_of(build_modules(cfg, 1)), None


class Program:
    def __init__(self, cfg, stream, cands, traffic, seed, weight_seed, device) -> None:
        N = stream.num_nodes
        self.num_nodes = N
        self.setup = linkpred.build(stream, cands, traffic["protocol"]["batch_size"],
                                    cfg["num_neighbors"], eid_layout=True, seed=seed,
                                    device=device)
        self.modules = build_modules(cfg, N)
        for m in self.modules.values():
            m.to(device).eval()
        self.weights = weights.make(weights.shapes_of(self.modules), weight_seed, device)
        weights.load(self.modules, self.weights)
        _, self.core = build_tgn_hook_cores(self.modules["memory"], self.modules["encoder"],
                                            self.modules["decoder"], None, N, style="rowwise")
        self.captures = [Capture("scores", self.modules["decoder"])]
        self.carry = self.modules["memory"].init_state(device)
        self._snapshot: List[torch.Tensor] = []

    def fold(self) -> None:
        s = self.setup
        epoch, states = hook_epoch(s.streams["train"], s.hm, "train", s.dgs["train"], self.core)
        self.carry, states, _ = epoch(self.carry, states)
        s.hm.adopt_states("train", states)
        self._snapshot = [t.clone() for t in self._state_tensors()]

    def _state_tensors(self) -> List[torch.Tensor]:
        return list(self.carry) + self.setup.recency_state()

    def restore(self) -> None:
        for live, snap in zip(self._state_tensors(), self._snapshot):
            live.copy_(snap)
        for k in ("val", "test"):
            self.setup.tgb_hooks[k].reset_state()

    @staticmethod
    def scores_layout(out: torch.Tensor, B: int, Q: int) -> torch.Tensor:
        """The decoder's output as (B, Q + 1), the positive first."""
        return out.reshape(B, Q + 1)

    def final_state(self) -> Dict[str, torch.Tensor]:
        N = self.num_nodes
        st = {k: v[:N].cpu() for k, v in self.carry._asdict().items()}
        ids, times, eids, wp = (t.cpu() for t in self.setup.recency_state())
        st.update(ring_canonical(ids[:N], times[:N], eids[:N], wp[:N]))
        return st
