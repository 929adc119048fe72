"""FLOPs and bytes of ``dygformer-wiki``'s work, from its widths and a
batch's real sizes. A multiply-add is 2 FLOPs. Each scored pair is a
sequence of 2L tokens of width D = channels x C; the positions of a node
with fewer than L - 1 neighbours are padded and are the model's own work
(DyGLib computes them too), the PAD seed slots of the batch are not. The
node features are DyGLib's zeros of width ``node_feat_dim``, projected as
any other channel."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple


def _dims(cfg: Mapping):
    C, L = cfg["channel_embedding_dim"], cfg["max_input_sequence_length"]
    return C, cfg["num_channels"] * C, 2 * L // cfg["patch_size"], cfg["ffn_dim"]


def stack_work(cfg: Mapping, sz: Mapping) -> Tuple[float, float]:
    """(FLOPs, bytes) of the transformer stack over the batch's real pairs:
    the products of every layer; fp32 patches in and out, bf16 weights."""
    C, D, S, F = _dims(cfg)
    per_layer = 2 * S * D * 3 * D + 2 * 2 * S * S * D + 2 * S * D * D + 2 * 2 * S * D * F
    R = sz["scored_pairs"]
    flops = R * cfg["num_layers"] * per_layer
    weights = cfg["num_layers"] * 2 * (3 * D * D + D * D + 2 * D * F)
    return float(flops), float(2 * R * S * D * 4 + weights)


def model_flops(cfg: Mapping, sz: Mapping) -> Dict[str, float]:
    """The model's FLOPs of one eval batch by peak precision: the stack
    (bf16) and, in fp32, the four channel projections and the
    co-occurrence encoding of every token, the output layer of both
    sides and the decoder of every pair."""
    C, D, S, F = _dims(cfg)
    T, De, Dn = cfg["time_dim"], cfg["edge_dim"], cfg["node_feat_dim"]
    R = sz["scored_pairs"]
    per_token = 2 * C * (Dn + De + T + C) + 2 * 2 * (C + C * C)
    per_pair = S * per_token + 2 * 2 * D * cfg["output_dim"] + (
        2 * 2 * cfg["output_dim"] * cfg["decoder_hidden"] + 2 * cfg["decoder_hidden"])
    return {"bf16": stack_work(cfg, sz)[0], "fp32": float(R * per_pair)}
