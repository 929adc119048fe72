"""DyGFormer, forward only (port of ``tgm_tpu/nn/encoder/dygformer.py``).

Patch-based transformer over recent-neighbour sequences: each seed is
prepended to its own neighbour sequence, which is padded to
``max_input_sequence_length``; four channels (node features, edge features,
Time2Vec of the time gaps, neighbour co-occurrence counts) are patched and
projected to ``channel_embedding_dim`` each; the src and dst sequences are
joined into one (2P, 4C) sequence per pair and run through the transformer
stack; each side is mean-pooled and projected by ``output_layer``.

The stack always runs through ``ops.transformer_stack_fwd`` (kernel K5 on
the card), as the JAX eval paths run it through the Pallas kernel with
``pallas_layers``. That makes this module forward-only: ``encode_pairs``,
the flax ``TransformerEncoder`` path and training are queued in ROADMAP.md.
Eval semantics: no dropout; the channel projections run in fp32
(``compute_bf16`` off), the stack with the kernel's bf16 operands.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...constants import PADDED_NODE_ID
from ...ops.dyg_transformer import Layer, StackWeights, stack_weights, transformer_stack_fwd
from ..modules.time_encoding import Time2Vec


class NeighborCooccurrenceEncoder(nn.Module):
    """Counts of each neighbour in its own and in the paired sequence, encoded.

    For a pair of (R, L) id sequences, each slot gets (appearances in its own
    sequence, appearances in the other), zero on PAD slots; each count goes
    through ``Linear(1, C) -> ReLU -> Linear(C, C)`` and the two are summed.
    """

    def __init__(self, feat_dim: int) -> None:
        super().__init__()
        self.enc = nn.Sequential(nn.Linear(1, feat_dim), nn.ReLU(), nn.Linear(feat_dim, feat_dim))

    def forward(self, src_nbrs: torch.Tensor,
                dst_nbrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cross = src_nbrs[:, None, :] == dst_nbrs[:, :, None]  # (R, L, L)
        src_self = src_nbrs[:, None, :] == src_nbrs[:, :, None]
        dst_self = dst_nbrs[:, None, :] == dst_nbrs[:, :, None]
        src_freq = torch.stack([src_self.sum(dim=1), cross.sum(dim=1)], dim=2).float()
        dst_freq = torch.stack([dst_self.sum(dim=1), cross.sum(dim=2)], dim=2).float()
        src_freq = torch.where((src_nbrs == PADDED_NODE_ID)[:, :, None], 0.0, src_freq)
        dst_freq = torch.where((dst_nbrs == PADDED_NODE_ID)[:, :, None], 0.0, dst_freq)
        return self.enc(src_freq[..., None]).sum(dim=2), self.enc(dst_freq[..., None]).sum(dim=2)


class TransformerLayer(nn.Module):
    """Parameters of one pre-LN transformer layer (LN -> MHA -> residual ->
    LN -> FFN with exact gelu -> residual). It has no forward of its own: the
    whole stack runs in ``transformer_stack_fwd``."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-5)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn1 = nn.Linear(dim, 4 * dim)
        self.ffn2 = nn.Linear(4 * dim, dim)


class DyGFormer(nn.Module):
    requires = frozenset({"nbr_nids", "nbr_edge_time", "nbr_edge_x"})

    def __init__(
        self,
        node_feat_dim: int,
        edge_x_dim: int,
        time_feat_dim: int,
        channel_embedding_dim: int,
        output_dim: int = 172,
        patch_size: int = 1,
        num_layers: int = 2,
        num_heads: int = 2,
        max_input_sequence_length: int = 512,
        num_channels: int = 4,
    ) -> None:
        super().__init__()
        if max_input_sequence_length % patch_size != 0:
            raise ValueError("Max sequence length must be a multiple of patch size")
        C = channel_embedding_dim
        self.patch_size = patch_size
        self.max_input_sequence_length = max_input_sequence_length
        self.num_patches = max_input_sequence_length // patch_size
        self.num_heads = num_heads
        self.num_channels = num_channels
        self.channel_embedding_dim = C
        self.time_encoder = Time2Vec(time_feat_dim)
        self.co_occurrence_encoder = NeighborCooccurrenceEncoder(C)
        self.proj_node = nn.Linear(patch_size * node_feat_dim, C)
        self.proj_edge = nn.Linear(patch_size * edge_x_dim, C)
        self.proj_time = nn.Linear(patch_size * time_feat_dim, C)
        self.proj_cooc = nn.Linear(patch_size * C, C)
        self.transformers = nn.ModuleList(
            [TransformerLayer(num_channels * C) for _ in range(num_layers)])
        self.output_layer = nn.Linear(num_channels * C, output_dim)

    @property
    def num_layers(self) -> int:
        return len(self.transformers)

    def _to_seq_len(self, x: torch.Tensor, fill) -> torch.Tensor:
        """Pad or trim the neighbour axis to max_input_sequence_length."""
        L, cur = self.max_input_sequence_length, x.shape[1]
        if cur >= L:
            return x[:, cur - L:]
        pad = torch.full((x.shape[0], L - cur) + tuple(x.shape[2:]), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad], dim=1)

    def _patches(self, feat: torch.Tensor) -> torch.Tensor:
        R, L, D = feat.shape
        return feat.reshape(R, self.num_patches, self.patch_size * D)

    def _side(self, seed, seed_time, nbrs, ntime, nfeat):
        """Prepend the seed to its own sequence and pad to L."""
        R = seed.shape[0]
        nbrs = torch.cat([seed[:, None].to(nbrs.dtype), nbrs], dim=1)
        ntime = torch.cat([seed_time[:, None].to(ntime.dtype), ntime], dim=1)
        nfeat = torch.cat([nfeat.new_zeros((R, 1, nfeat.shape[-1])), nfeat], dim=1)
        return (self._to_seq_len(nbrs, PADDED_NODE_ID), self._to_seq_len(ntime, 0),
                self._to_seq_len(nfeat, 0.0))

    @staticmethod
    def _node_feats(node_x, nbrs):
        f = node_x[nbrs.clamp_min(0).long()]
        return torch.where((nbrs == PADDED_NODE_ID)[..., None], 0.0, f)

    def _time_feats(self, nbrs, ntime, seed_time):
        f = self.time_encoder((seed_time[:, None] - ntime).float())
        return torch.where((nbrs == PADDED_NODE_ID)[..., None], 0.0, f)

    def stack_weights(self) -> StackWeights:
        """The stack's weights in the kernel's layout; convert once per eval."""
        return stack_weights(dygformer_stack_layers(self), self.num_heads)

    def forward(
        self,
        node_x: torch.Tensor,  # (num_nodes, d_N)
        edge_src: torch.Tensor,  # (B,)
        edge_dst: torch.Tensor,  # (B,)
        edge_time: torch.Tensor,  # (B,)
        neighbours: torch.Tensor,  # (2B, K) [src rows then dst rows]
        neighbours_time: torch.Tensor,  # (2B, K)
        neighbours_edge_feat: torch.Tensor,  # (2B, K, d_E)
        stack: Optional[StackWeights] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_src, z_dst), each (B, output_dim). ``stack`` is
        :meth:`stack_weights`, converted once by the caller (else here)."""
        B = edge_src.shape[0]
        s_n, s_t, s_e = self._side(edge_src, edge_time, neighbours[:B], neighbours_time[:B],
                                   neighbours_edge_feat[:B])
        d_n, d_t, d_e = self._side(edge_dst, edge_time, neighbours[B:2 * B],
                                   neighbours_time[B:2 * B], neighbours_edge_feat[B:2 * B])
        s_cooc, d_cooc = self.co_occurrence_encoder(s_n, d_n)

        def channels(nbrs, ntime, nfeat, cooc):
            return (
                self.proj_node(self._patches(self._node_feats(node_x, nbrs))),
                self.proj_edge(self._patches(nfeat)),
                self.proj_time(self._patches(self._time_feats(nbrs, ntime, edge_time))),
                self.proj_cooc(self._patches(cooc)),
            )

        P = self.num_patches
        joined = [torch.cat([s, d], dim=1) for s, d in zip(channels(s_n, s_t, s_e, s_cooc),
                                                           channels(d_n, d_t, d_e, d_cooc))]
        patches = torch.stack(joined, dim=2).reshape(
            B, 2 * P, self.num_channels * self.channel_embedding_dim)
        patches = transformer_stack_fwd(patches.float().contiguous(),
                                        self.stack_weights() if stack is None else stack,
                                        self.num_heads)
        # One output projection for both sides: equal rows come out equal.
        z = self.output_layer(torch.cat([patches[:, :P].mean(dim=1), patches[:, P:].mean(dim=1)]))
        return z[:B], z[B:]


def dygformer_stack_layers(encoder: DyGFormer) -> List[Layer]:
    """The encoder's transformer layers as the stack's flat per-layer dicts
    (counterpart of the JAX ``dygformer_pallas_layers``)."""
    layers = []
    for t in encoder.transformers:
        layers.append({k: v.detach().float() for k, v in {
            "ln1_scale": t.ln1.weight, "ln1_bias": t.ln1.bias,
            "wqkv": torch.cat([t.query.weight.T, t.key.weight.T, t.value.weight.T], dim=1),
            "bqkv": torch.cat([t.query.bias, t.key.bias, t.value.bias]),
            "wo": t.out.weight.T, "bo": t.out.bias,
            "ln2_scale": t.ln2.weight, "ln2_bias": t.ln2.bias,
            "w1": t.ffn1.weight.T, "b1": t.ffn1.bias,
            "w2": t.ffn2.weight.T, "b2": t.ffn2.bias,
        }.items()})
    return layers
