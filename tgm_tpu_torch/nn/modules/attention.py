"""Multi-head temporal attention (port of ``tgm_tpu/nn/modules/attention.py``).

TGAT's attention of each seed over its K neighbours: Q from [node ‖ time],
K and V from [neighbour node ‖ edge ‖ time], output width ``node_dim +
time_dim`` padded up to a multiple of ``n_heads`` (the zero padding goes on
the node features, before the time features are appended), ``-1e10``
masking (a row with no valid neighbour softmaxes uniformly over its padded
slots, as the reference does), dropout on the attention weights and on
the output, residual and LayerNorm (eps 1e-5).

Dropout is drawn from the ``generator`` passed to ``forward``, one
elementwise mask of the (B, H, K) weights and one of the (B, out_dim)
output per call, and only when one is passed: a call without a generator
is deterministic whatever the module's train/eval mode. ``score_layout``
takes the JAX values: ``"lanes"`` is the same function in another TPU
layout, and the port computes one layout.

``kv_bf16=True`` is the JAX bf16 K/V path, rounding where flax rounds
(``modules/bf16.py``): the three K/V operands are cast to bf16 before the
concat; ``W_KV`` is ``nn.Dense(dtype=bf16)`` (no bias), so K and V are the
fp32-accumulated product rounded to bf16; q (fp32 from ``W_Q``) is cast to
bf16; the scores are fp32 sums of the bf16 products, scaled, masked and
softmaxed in fp32; the weights are cast to bf16 for the value product,
which sums in fp32. ``W_Q``, ``W_O``, the residual and the LayerNorm stay
fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bf16 import BF16, einsum_f32
from .dropout import dropout as _dropout

SCORE_LAYOUTS = ("kmajor", "lanes")


class TemporalAttention(nn.Module):
    """``W_Q`` and ``W_KV`` have no bias, ``W_O`` has one; ``W_KV`` maps
    [node ‖ edge ‖ time] to [K ‖ V] (2 * out_dim)."""

    def __init__(
        self,
        n_heads: int,
        node_dim: int,
        edge_dim: int,
        time_dim: int,
        dropout: float = 0.1,
        kv_bf16: bool = False,
        score_layout: str = "kmajor",
    ) -> None:
        super().__init__()
        if min(n_heads, node_dim, edge_dim, time_dim) <= 0:
            raise ValueError("n_heads, node_dim, edge_dim, time_dim must be > 0")
        if score_layout not in SCORE_LAYOUTS:
            raise ValueError(f"score_layout must be one of {SCORE_LAYOUTS}, got {score_layout!r}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.kv_bf16 = kv_bf16
        out_dim = node_dim + time_dim
        self.pad_dim = (-out_dim) % n_heads
        self.out_dim = out_dim + self.pad_dim
        self.head_dim = self.out_dim // n_heads
        self.W_Q = nn.Linear(self.out_dim, self.out_dim, bias=False)
        self.W_KV = nn.Linear(node_dim + edge_dim + time_dim, 2 * self.out_dim, bias=False)
        self.W_O = nn.Linear(self.out_dim, self.out_dim)
        self.layer_norm = nn.LayerNorm(self.out_dim, eps=1e-5)

    def forward(
        self,
        node_x: torch.Tensor,  # (B, node_dim)
        time_feat: torch.Tensor,  # (B, time_dim)
        edge_feat: Optional[torch.Tensor],  # (B, K, edge_dim)
        nbr_node_feat: Optional[torch.Tensor],  # (B, K, node_dim)
        nbr_time_feat: torch.Tensor,  # (B, K, time_dim)
        valid_nbr_mask: torch.Tensor,  # (B, K) bool
        generator: Optional[torch.Generator] = None,
        kv_node_edge_feat: Optional[torch.Tensor] = None,  # (B, K, node_dim + edge_dim)
    ) -> torch.Tensor:
        """(B, out_dim). With ``kv_node_edge_feat`` (rows of a side-augmented
        table, [neighbour node ‖ edge] pre-concatenated) ``nbr_node_feat`` and
        ``edge_feat`` are not read: the same K/V input."""
        B, K = valid_nbr_mask.shape
        H, dh = self.n_heads, self.head_dim
        x = F.pad(node_x, (0, self.pad_dim)) if self.pad_dim else node_x
        R = torch.cat([x, time_feat], dim=-1)  # (B, out_dim)
        q = self.W_Q(R).reshape(B, H, dh)
        kv_in = ([kv_node_edge_feat, nbr_time_feat] if kv_node_edge_feat is not None
                 else [nbr_node_feat, edge_feat, nbr_time_feat])
        if self.kv_bf16:
            Z = torch.cat([t.to(BF16) for t in kv_in], dim=-1)
            Z = (Z.float() @ self.W_KV.weight.to(BF16).float().T).to(BF16)
        else:
            Z = self.W_KV(torch.cat([t.float() for t in kv_in], dim=-1))  # (B, K, 2 * out_dim)
        k = Z[..., : self.out_dim].reshape(B, K, H, dh)
        v = Z[..., self.out_dim :].reshape(B, K, H, dh)

        attn = einsum_f32("bhd,bkhd->bhk", q.to(Z.dtype), k) * (dh ** -0.5)
        attn = torch.where(valid_nbr_mask[:, None, :], attn, -1e10)
        attn = torch.softmax(attn, dim=-1)
        attn = _dropout(attn, self.dropout, generator)
        out = einsum_f32("bhk,bkhd->bhd", attn.to(Z.dtype), v).reshape(B, self.out_dim)
        out = _dropout(self.W_O(out), self.dropout, generator)
        return self.layer_norm(out + R)


__all__ = ["SCORE_LAYOUTS", "TemporalAttention"]
