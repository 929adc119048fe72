"""DyGFormer (port of ``tgm_tpu/nn/encoder/dygformer.py``).

Patch-based transformer over recent-neighbour sequences: each seed is
prepended to its own neighbour sequence, which is padded to
``max_input_sequence_length``; four channels (node features, edge features,
Time2Vec of the time gaps, neighbour co-occurrence counts) are patched and
projected to ``channel_embedding_dim`` each; the src and dst sequences are
joined into one (2P, 4C) sequence per pair and run through the transformer
stack; each side is mean-pooled and projected by ``output_layer``.

The stack runs as the JAX ``_run_stack`` runs it. Without ``stack`` it is
the layers' own ``TransformerEncoder`` modules (the flax path: autograd,
and dropout when the call is not ``deterministic``), which training uses.
With ``stack`` (:meth:`DyGFormer.stack_weights`, the JAX
``pallas_layers``) it is ``ops.transformer_stack_fwd``: kernel K5 on the
card, its plain version on the CPU; forward only, without dropout, which
the eval paths use. ``encode_pairs`` runs both training pairs, (src, dst)
and (src, neg), in one forward.

``compute_bf16`` is the JAX bf16 path, rounding where flax rounds
(``nn/modules/bf16.py``; parameters stay fp32):
- the co-occurrence MLP, the four channel projections, every dense of the
  stack and the attention run as ``nn.Dense(dtype=bf16)``: inputs, kernels
  and biases in bf16, products rounded, biases added in bf16; the
  co-occurrence pair sum rounds once;
- flax attention (``nn.MultiHeadDotProductAttention(dtype=bf16)``): q
  divided by bf16(sqrt(dh)) in bf16, the scores rounded to bf16, the
  softmax in bf16 step by step (x - max, exp, the fp32 sum rounded, the
  quotient), attention dropout as a bf16 multiplier, the value product
  rounded to bf16; ``FusedSelfAttention`` keeps fp32 scores, softmax and
  value sums (bf16 operands) and rounds only its denses;
- the patches, the residual stream and the adds are bf16, except where an
  fp32 input promotes them; the LayerNorms are flax's fp32 ones (fast
  variance) with fp32 output; gelu (exact) rounds each step;
- the stack's output is mean-pooled in fp32 and rounded to bf16, and
  ``output_layer`` runs in fp32 on it. Through K5 (``stack``), the kernel
  takes the bf16 patches as fp32 and its output is rounded back to bf16.

``bf16_stream`` (with ``compute_bf16``) casts each layer's input to bf16
and uses ``LayerNormBF16`` (fp32 two-pass statistics, bf16 output); K5 does
not take it (``stack_weights`` raises), as the JAX ``dygformer_pallas_layers``
does not.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...constants import PADDED_NODE_ID
from ...ops.dyg_transformer import Layer, StackWeights, stack_weights, transformer_stack_fwd
from ..modules.bf16 import (
    BF16,
    LayerNormBF16,
    dense,
    einsum_f32,
    flax_layer_norm,
    gelu_bf16,
    softmax_bf16,
)
from ..modules.dropout import dropout
from ..modules.time_encoding import Time2Vec


class NeighborCooccurrenceEncoder(nn.Module):
    """Counts of each neighbour in its own and in the paired sequence, encoded.

    For a pair of (R, L) id sequences, each slot gets (appearances in its own
    sequence, appearances in the other), zero on PAD slots; each count goes
    through ``Linear(1, C) -> ReLU -> Linear(C, C)`` and the two are summed
    (``dtype=bf16``: bf16 denses, the sum rounded once).
    """

    def __init__(self, feat_dim: int, dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.enc = nn.Sequential(nn.Linear(1, feat_dim), nn.ReLU(), nn.Linear(feat_dim, feat_dim))

    def _encode(self, freq: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return self.enc(freq[..., None]).sum(dim=2)
        h = torch.relu(dense(freq[..., None], self.enc[0], self.dtype))
        return dense(h, self.enc[2], self.dtype).float().sum(dim=2).to(self.dtype)

    def forward(self, src_nbrs: torch.Tensor,
                dst_nbrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cross = src_nbrs[:, None, :] == dst_nbrs[:, :, None]  # (R, L, L)
        src_self = src_nbrs[:, None, :] == src_nbrs[:, :, None]
        dst_self = dst_nbrs[:, None, :] == dst_nbrs[:, :, None]
        src_freq = torch.stack([src_self.sum(dim=1), cross.sum(dim=1)], dim=2).float()
        dst_freq = torch.stack([dst_self.sum(dim=1), cross.sum(dim=2)], dim=2).float()
        src_freq = torch.where((src_nbrs == PADDED_NODE_ID)[:, :, None], 0.0, src_freq)
        dst_freq = torch.where((dst_nbrs == PADDED_NODE_ID)[:, :, None], 0.0, dst_freq)
        return self._encode(src_freq), self._encode(dst_freq)


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention as flax ``nn.MultiHeadDotProductAttention`` computes it:
    ``query``/``key``/``value``/``out`` (D, D) projections, q scaled by
    1 / sqrt(dh) before the q.k product, fp32 softmax. Dropout is on the
    attention weights, one (S, S) mask per call shared by every sequence and
    head (flax's ``broadcast_dropout=True``). ``dtype=bf16``: the module
    docstring's rounding points."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim={dim} is not a multiple of num_heads={num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, h: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, D = h.shape
        H = self.num_heads
        dh = D // H
        if self.dtype is not None:
            return self._forward_in_dtype(h, generator)
        q = dense(h, self.query).reshape(B, S, H, dh) / math.sqrt(dh)
        k = dense(h, self.key).reshape(B, S, H, dh)
        v = dense(h, self.value).reshape(B, S, H, dh)
        a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        a = dropout(a, self.dropout, generator, mask_shape=(S, S))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, D))

    def _forward_in_dtype(self, h: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """flax's ``dot_product_attention`` in ``self.dtype``: every step's
        result in that dtype."""
        B, S, D = h.shape
        H, dt = self.num_heads, self.dtype
        dh = D // H
        proj = lambda lin: dense(h, lin, dt).reshape(B, S, H, dh)
        q = proj(self.query) / float(torch.tensor(math.sqrt(dh)).to(dt))
        a = softmax_bf16(einsum_f32("bqhd,bkhd->bhqk", q, proj(self.key)).to(dt), dim=-1)
        if generator is not None and self.dropout > 0.0:
            keep = torch.rand((S, S), generator=generator, device=h.device) < 1.0 - self.dropout
            a = a * (keep.to(dt) / torch.tensor(1.0 - self.dropout, dtype=dt, device=h.device))
        o = einsum_f32("bhqk,bkhd->bqhd", a, proj(self.value)).to(dt)
        return dense(o.reshape(B, S, D), self.out, dt)


class FusedSelfAttention(nn.Module):
    """The JAX ``FusedSelfAttention`` (``fused_attn=True``): one (D, 3D)
    ``qkv`` projection, logits scaled after the q.k product, fp32 softmax,
    ``out`` (D, D). Dropout is on the attention weights as flax ``nn.Dropout``
    applies it there: a mask of their whole (B, H, S, S) shape. ``dtype=bf16``:
    bf16 ``qkv`` and ``out`` denses; the scores, softmax and value sums stay
    fp32 (bf16 operands)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim={dim} is not a multiple of num_heads={num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, h: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, D = h.shape
        H = self.num_heads
        dh = D // H
        qkv = dense(h, self.qkv, self.dtype)
        q, k, v = (t.reshape(B, S, H, dh) for t in qkv.split(D, dim=-1))
        a = torch.softmax(einsum_f32("bqhd,bkhd->bhqk", q, k) * dh ** -0.5, dim=-1)
        a = dropout(a, self.dropout, generator)
        o = einsum_f32("bhqk,bkhd->bqhd", a.to(qkv.dtype), v).reshape(B, S, D)
        return dense(o, self.out, self.dtype)


class TransformerEncoder(nn.Module):
    """One pre-LN transformer layer, the JAX ``TransformerEncoder``: LN (eps
    1e-5) -> attention -> dropout -> residual -> LN -> ``ffn1`` (4D) -> exact
    gelu -> dropout -> ``ffn2`` (D) -> dropout -> residual.

    Every dropout mask is drawn from the ``generator`` passed to ``forward``,
    and only when one is passed. ``dtype=bf16`` computes as the module
    docstring says; ``bf16_stream`` casts the input to bf16 and makes both
    LayerNorms ``LayerNormBF16``."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 fused_attn: bool = False, dtype: Optional[torch.dtype] = None,
                 bf16_stream: bool = False) -> None:
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.bf16_stream = bf16_stream
        ln = (lambda: LayerNormBF16(dim)) if bf16_stream else (lambda: nn.LayerNorm(dim, eps=1e-5))
        self.ln1 = ln()
        attn = FusedSelfAttention if fused_attn else MultiHeadDotProductAttention
        self.attn = attn(dim, num_heads, dropout, dtype)
        self.ln2 = ln()
        self.ffn1 = nn.Linear(dim, 4 * dim)
        self.ffn2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, dt = self.dropout, self.dtype
        if dt is None and not self.bf16_stream:
            out = x + dropout(self.attn(self.ln1(x), generator), p, generator)
            h = dropout(F.gelu(self.ffn1(self.ln2(out))), p, generator)
            return out + dropout(self.ffn2(h), p, generator)
        if self.bf16_stream:
            x = x.to(BF16)
            norm = lambda ln, t: ln(t)
        else:
            norm = lambda ln, t: flax_layer_norm(t, ln)
        out = x + dropout(self.attn(norm(self.ln1, x), generator), p, generator)
        h = dense(norm(self.ln2, out), self.ffn1, dt)
        h = dropout(gelu_bf16(h) if h.dtype == BF16 else F.gelu(h), p, generator)
        return out + dropout(dense(h, self.ffn2, dt), p, generator)


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
        dropout: float = 0.1,
        max_input_sequence_length: int = 512,
        num_channels: int = 4,
        compute_bf16: bool = False,
        fused_attn: bool = False,
        bf16_stream: bool = False,
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
        self.dropout = dropout
        dt = BF16 if compute_bf16 else None
        self.compute_dtype = dt
        self.time_encoder = Time2Vec(time_feat_dim)
        self.co_occurrence_encoder = NeighborCooccurrenceEncoder(C, dt)
        self.proj_node = nn.Linear(patch_size * node_feat_dim, C)
        self.proj_edge = nn.Linear(patch_size * edge_x_dim, C)
        self.proj_time = nn.Linear(patch_size * time_feat_dim, C)
        self.proj_cooc = nn.Linear(patch_size * C, C)
        self.transformers = nn.ModuleList(
            [TransformerEncoder(num_channels * C, num_heads, dropout, fused_attn, dt,
                                bf16_stream and compute_bf16)
             for _ in range(num_layers)])
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

    def _proj(self, lin: nn.Linear, feat: torch.Tensor) -> torch.Tensor:
        """A channel's patches through its projection, in the compute dtype."""
        return dense(self._patches(feat), lin, self.compute_dtype)

    @staticmethod
    def _pool(patches: torch.Tensor) -> torch.Tensor:
        """Mean over the patches, summed in fp32 and rounded to their dtype."""
        return patches.float().mean(dim=1).to(patches.dtype)

    def stack_weights(self) -> StackWeights:
        """The stack's weights in the kernel's layout; convert once per eval,
        after the last optimizer step."""
        return stack_weights(dygformer_stack_layers(self), self.num_heads)

    def _run_stack(self, patches: torch.Tensor, deterministic: bool,
                   stack: Optional[StackWeights],
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """The layers' modules (``stack`` None), or the whole stack through
        ``transformer_stack_fwd``, which has no dropout and no backward."""
        if stack is not None:
            if not deterministic:
                raise ValueError("the stack kernel has no dropout: pass stack=None to train")
            out = transformer_stack_fwd(patches.float().contiguous(), stack, self.num_heads)
            return out.to(patches.dtype)
        if deterministic:
            generator = None
        elif generator is None and self.dropout > 0.0:
            raise ValueError("deterministic=False with dropout needs a generator")
        for tr in self.transformers:
            patches = tr(patches, generator)
        return patches

    def forward(
        self,
        node_x: torch.Tensor,  # (num_nodes, d_N)
        edge_src: torch.Tensor,  # (B,)
        edge_dst: torch.Tensor,  # (B,)
        edge_time: torch.Tensor,  # (B,)
        neighbours: torch.Tensor,  # (2B, K) [src rows then dst rows]
        neighbours_time: torch.Tensor,  # (2B, K)
        neighbours_edge_feat: torch.Tensor,  # (2B, K, d_E)
        deterministic: bool = True,
        stack: Optional[StackWeights] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_src, z_dst), each (B, output_dim). ``stack``: see the module
        docstring; ``generator`` draws the dropout masks when
        ``deterministic`` is False."""
        B = edge_src.shape[0]
        s_n, s_t, s_e = self._side(edge_src, edge_time, neighbours[:B], neighbours_time[:B],
                                   neighbours_edge_feat[:B])
        d_n, d_t, d_e = self._side(edge_dst, edge_time, neighbours[B:2 * B],
                                   neighbours_time[B:2 * B], neighbours_edge_feat[B:2 * B])
        s_cooc, d_cooc = self.co_occurrence_encoder(s_n, d_n)

        def channels(nbrs, ntime, nfeat, cooc):
            return (
                self._proj(self.proj_node, self._node_feats(node_x, nbrs)),
                self._proj(self.proj_edge, nfeat),
                self._proj(self.proj_time, self._time_feats(nbrs, ntime, edge_time)),
                self._proj(self.proj_cooc, cooc),
            )

        P = self.num_patches
        joined = [torch.cat([s, d], dim=1) for s, d in zip(channels(s_n, s_t, s_e, s_cooc),
                                                           channels(d_n, d_t, d_e, d_cooc))]
        patches = torch.stack(joined, dim=2).reshape(
            B, 2 * P, self.num_channels * self.channel_embedding_dim)
        patches = self._run_stack(patches, deterministic, stack, generator)
        # One output projection for both sides: equal rows come out equal.
        z = dense(torch.cat([self._pool(patches[:, :P]), self._pool(patches[:, P:])]),
                  self.output_layer)
        return z[:B], z[B:]

    def encode_pairs(
        self,
        node_x: torch.Tensor,  # (num_nodes, d_N)
        edge_src: torch.Tensor,  # (B,)
        edge_dst: torch.Tensor,  # (B,)
        neg: torch.Tensor,  # (B,)
        edge_time: torch.Tensor,  # (B,)
        neighbours: torch.Tensor,  # (3B, K) [src; dst; neg] rows from the hook
        neighbours_time: torch.Tensor,  # (3B, K)
        neighbours_edge_feat: torch.Tensor,  # (3B, K, d_E)
        deterministic: bool = True,
        stack: Optional[StackWeights] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One forward for both training pairs, (src, dst) and (src, neg).

        The same function as two :meth:`forward` calls (the negative side
        takes the positive edge's time), with the src channels projected once
        and the stack run once over (2B, 2P, D). Returns ``(z_src, z_dst,
        z_src2, z_neg)``; ``z_src`` and ``z_src2`` differ, since the
        co-occurrence channel depends on the paired sequence.
        """
        B = edge_src.shape[0]
        seeds = torch.cat([edge_src, edge_dst, neg])
        seed_times = torch.cat([edge_time, edge_time, edge_time])
        seq_n, seq_t, seq_e = self._side(seeds, seed_times, neighbours, neighbours_time,
                                         neighbours_edge_feat)
        # Channels shared by all 3B sequences (src projected once).
        ch_node = self._proj(self.proj_node, self._node_feats(node_x, seq_n))
        ch_edge = self._proj(self.proj_edge, seq_e)
        ch_time = self._proj(self.proj_time, self._time_feats(seq_n, seq_t, seed_times))
        # The co-occurrence channel depends on the pair: left = src (twice),
        # right = [dst; neg].
        s_n = seq_n[:B]
        left_cooc, right_cooc = self.co_occurrence_encoder(torch.cat([s_n, s_n]), seq_n[B:])
        left_cooc = self._proj(self.proj_cooc, left_cooc)  # (2B, P, C)
        right_cooc = self._proj(self.proj_cooc, right_cooc)

        def pair_join(ch):  # (3B, P, C) -> (2B, 2P, C); rows [0:B] positive, [B:2B] negative
            return torch.cat([torch.cat([ch[:B], ch[:B]]), ch[B:]], dim=1)

        joined = [pair_join(ch_node), pair_join(ch_edge), pair_join(ch_time),
                  torch.cat([left_cooc, right_cooc], dim=1)]
        P = self.num_patches
        patches = torch.stack(joined, dim=2).reshape(
            2 * B, 2 * P, self.num_channels * self.channel_embedding_dim)
        patches = self._run_stack(patches, deterministic, stack, generator)
        out = dense(torch.cat([self._pool(patches[:, :P]), self._pool(patches[:, P:])]),
                    self.output_layer)
        return out[:B], out[2 * B:3 * B], out[B:2 * B], out[3 * B:]


def dygformer_stack_layers(encoder: DyGFormer) -> List[Layer]:
    """The encoder's transformer layers as the stack's flat per-layer dicts
    (counterpart of the JAX ``dygformer_pallas_layers``); needs the flax-MHA
    attention layout (``fused_attn=False``), as the JAX function does."""
    layers = []
    for t in encoder.transformers:
        a = t.attn
        if not isinstance(a, MultiHeadDotProductAttention):
            raise ValueError("the stack kernel needs the flax-MHA layout (fused_attn=False)")
        if t.bf16_stream:
            raise ValueError("the stack kernel needs fp32 LayerNorms (bf16_stream=False)")
        layers.append({k: v.detach().float() for k, v in {
            "ln1_scale": t.ln1.weight, "ln1_bias": t.ln1.bias,
            "wqkv": torch.cat([a.query.weight.T, a.key.weight.T, a.value.weight.T], dim=1),
            "bqkv": torch.cat([a.query.bias, a.key.bias, a.value.bias]),
            "wo": a.out.weight.T, "bo": a.out.bias,
            "ln2_scale": t.ln2.weight, "ln2_bias": t.ln2.bias,
            "w1": t.ffn1.weight.T, "b1": t.ffn1.bias,
            "w2": t.ffn2.weight.T, "b2": t.ffn2.bias,
        }.items()})
    return layers
