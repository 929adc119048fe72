"""FLOPs and bytes of ``tgn-wiki``'s work, from its widths and a batch's
real sizes (PAD slots need nothing). A multiply-add is 2 FLOPs."""

from __future__ import annotations

from typing import Dict, Mapping


def model_flops(cfg: Mapping, sz: Mapping) -> Dict[str, float]:
    """The model's FLOPs of one eval batch, by peak precision: the rowwise
    attention of each real seed over its valid neighbours, the decoder over
    every scored pair, the GRU update of each touched node."""
    M, E, T, D = cfg["memory_dim"], cfg["embedding_dim"], cfg["time_dim"], cfg["edge_dim"]
    H = cfg["decoder_hidden"]
    seeds, nbrs = sz["real_seeds"], sz["valid_nbrs"]
    per_seed = 2 * M * E * 2  # lin_query, lin_skip
    per_nbr = 2 * M * E * 2 + 2 * (T + D) * E + 2 * E * 2  # key, value; lin_edge; q.k, alpha.v
    per_pair = 2 * 2 * E * H + 2 * H
    gru_in = 2 * M + D + T
    per_node = 2 * gru_in * 3 * M + 2 * M * 3 * M
    total = (seeds * per_seed + nbrs * per_nbr + sz["scored_pairs"] * per_pair
             + sz["touched_nodes"] * per_node)
    return {"fp32": float(total)}


def k1_bytes(cfg: Mapping, sz: Mapping) -> float:
    """Bytes K1 must move for the real seeds: each reads its seed, query
    time, write position and ring row (id, time, edge id) and writes K
    (id, time, edge id, feature row) slots; each valid neighbour's feature
    row is read once."""
    K, D = cfg["num_neighbors"], cfg["edge_dim"]
    per_seed = 12 + 12 * K + K * (12 + 4 * D)
    return float(sz["real_seeds"] * per_seed + sz["valid_nbrs"] * 4 * D)
