"""The program under test for ``dygformer-wiki``: DyGFormer eval as the
port's ``examples/linkproppred/dygformer.py`` runs it, feature-layout
recency (K4), the push, the stack through K5; with DyGLib's sequence (the
seed and its 31 most recent neighbours a side) and its zero node features
of the edge features' width.

The eval core is ``build_dygformer_eval_core(..., stack="kernel")``; its
carry is empty, so the state is the recency hook's alone, and the fold of
the train split runs the hooks without the model, as the example replays
a split. Besides the decoder's scores, the window keeps the four channel
projections of each side (the stack's input, the first ``CAPTURE_ROWS``
pairs) and the output layer's input (the pooled stack output), so that
the fp32 layers before and after the bf16 stack are judged on their own.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tgm_tpu_torch.nn import DyGFormer, LinkPredictor
from tgm_tpu_torch.train import build_dygformer_eval_core, hook_epoch

from portbench.yard import evalcell, linkpred, weights
from portbench.yard.checks import ring_canonical
from portbench.yard.window import Capture

CHANNELS = ("proj_node", "proj_edge", "proj_time", "proj_cooc")


def run_cell(cell, seed, seconds, trace, device, t_process, warm_batches=4):
    """One run of a cell of this configuration: TGB's eval protocol."""
    return evalcell.run(Program, cell, seed, seconds, trace, device, t_process, warm_batches)


def build_modules(cfg) -> Dict[str, torch.nn.Module]:
    return {
        "encoder": DyGFormer(
            node_feat_dim=cfg["node_feat_dim"], edge_x_dim=cfg["edge_dim"],
            time_feat_dim=cfg["time_dim"], channel_embedding_dim=cfg["channel_embedding_dim"],
            output_dim=cfg["output_dim"], patch_size=cfg["patch_size"],
            num_layers=cfg["num_layers"], num_heads=cfg["num_heads"], dropout=0.0,
            max_input_sequence_length=cfg["max_input_sequence_length"]),
        "decoder": LinkPredictor(node_dim=cfg["output_dim"], hidden_dim=cfg["decoder_hidden"],
                                 nlayers=cfg["decoder_layers"]),
    }


def weight_shapes(cfg):
    """The weights' names and shapes, and a maker of the node features:
    zeros of ``node_feat_dim`` (tgbl-wiki has none; DyGLib pads with zeros)."""
    def extra(stream, seed, device):
        return {"node_x": torch.zeros((stream.num_nodes, cfg["node_feat_dim"]), device=device)}
    return weights.shapes_of(build_modules(cfg)), extra


class Program:
    # Pairs of a batch whose channel projections the window keeps: the
    # positives and the first candidates (the program's order).
    CAPTURE_ROWS = 1_050

    def __init__(self, cfg, stream, cands, traffic, seed, weight_seed, device) -> None:
        N = stream.num_nodes
        self.num_nodes = N
        self.setup = linkpred.build(stream, cands, traffic["protocol"]["batch_size"],
                                    cfg["num_neighbors"], eid_layout=False, seed=seed,
                                    device=device)
        self.modules = build_modules(cfg)
        for m in self.modules.values():
            m.to(device).eval()
        shapes, extra = weight_shapes(cfg)
        self.weights = weights.make(shapes, weight_seed, device)
        self.weights.update(extra(stream, seed, device))
        weights.load(self.modules, self.weights)
        self.core = build_dygformer_eval_core(self.modules["encoder"], self.modules["decoder"],
                                              self.weights["node_x"], N, stack="kernel")
        enc = self.modules["encoder"]
        self.captures = ([Capture("scores", self.modules["decoder"]),
                          Capture("pooled", enc.output_layer, "in")]
                         + [Capture(c, getattr(enc, c), "out", self.CAPTURE_ROWS)
                            for c in CHANNELS])
        self.carry = None
        self._snapshot: List[torch.Tensor] = []

    def fold(self) -> None:
        s = self.setup
        epoch, states = hook_epoch(s.streams["train"], s.hm, "train", s.dgs["train"],
                                   lambda carry, batch: (carry, torch.zeros(())))
        _, states, _ = epoch(None, states)
        s.hm.adopt_states("train", states)
        self._snapshot = [t.clone() for t in s.recency_state()]

    def restore(self) -> None:
        for live, snap in zip(self.setup.recency_state(), self._snapshot):
            live.copy_(snap)
        for k in ("val", "test"):
            self.setup.tgb_hooks[k].reset_state()

    @staticmethod
    def scores_layout(out: torch.Tensor, B: int, Q: int) -> torch.Tensor:
        """The decoder's output [B positives | B * Q candidates] as (B, Q + 1)."""
        return torch.cat([out[:B, None], out[B:].reshape(B, Q)], dim=1)

    def final_state(self) -> Dict[str, torch.Tensor]:
        N = self.num_nodes
        ids, times, feats, wp = (t.cpu() for t in self.setup.recency_state())
        return ring_canonical(ids[:N], times[:N], feats[:N], wp[:N])
