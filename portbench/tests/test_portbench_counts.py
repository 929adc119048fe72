"""The FLOP and byte counters against hand counts at tiny shapes."""

import json

import pytest

from portbench import run
from portbench.yard.peaks import bound_s
from tiny import HERE


def _counts(name):
    return run.load_module(HERE / "configs" / name / "counts.py",
                           f"counts_{name.replace('-', '_')}")


def test_tgn_counts():
    c = _counts("tgn-wiki")
    cfg = {"memory_dim": 2, "embedding_dim": 4, "time_dim": 1, "edge_dim": 3,
           "decoder_hidden": 5, "num_neighbors": 2}
    sz = {"real_seeds": 3, "valid_nbrs": 4, "scored_pairs": 6, "touched_nodes": 2}
    per_seed = 2 * 2 * (2 * 4)  # lin_query and lin_skip: 2 x 4 products each
    per_nbr = 2 * 2 * (2 * 4) + 2 * (1 + 3) * 4 + 2 * 2 * 4
    per_pair = 2 * (8 * 5) + 2 * 5
    per_node = 2 * (2 + 2 + 3 + 1) * 6 + 2 * 2 * 6  # GRU: 3 gates of width 2
    want = 3 * per_seed + 4 * per_nbr + 6 * per_pair + 2 * per_node
    assert c.model_flops(cfg, sz) == {"fp32": want}
    # Per real seed: seed, time, write position (12), the ring row (2 x 12),
    # the output slots (2 x (12 + 12)); per valid neighbour its 3 features.
    assert c.k1_bytes(cfg, sz) == 3 * (12 + 24 + 48) + 4 * 12


def test_dygformer_counts():
    c = _counts("dygformer-wiki")
    cfg = {"channel_embedding_dim": 2, "num_channels": 4, "max_input_sequence_length": 3,
           "patch_size": 1, "ffn_dim": 5, "num_layers": 2, "time_dim": 1, "edge_dim": 2,
           "node_feat_dim": 1, "output_dim": 3, "decoder_hidden": 4}
    sz = {"scored_pairs": 7}
    D, S, F = 8, 6, 5
    layer = 2 * S * D * 3 * D + 2 * 2 * S * S * D + 2 * S * D * D + 2 * 2 * S * D * F
    flops, nbytes = c.stack_work(cfg, sz)
    assert flops == 7 * 2 * layer
    assert nbytes == 2 * 7 * S * D * 4 + 2 * 2 * (3 * D * D + D * D + 2 * D * F)
    per_token = 2 * 2 * (1 + 2 + 1 + 2) + 2 * 2 * (2 + 4)
    per_pair = S * per_token + 2 * 2 * D * 3 + 2 * 2 * 3 * 4 + 2 * 4
    assert c.model_flops(cfg, sz) == {"bf16": flops, "fp32": 7 * per_pair}


def test_bound_takes_the_longer_side():
    assert bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert bound_s(0.0, 989e12, "bf16") == pytest.approx(1.0)
    assert bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_real_configs_are_the_published_widths():
    tgn = json.loads((HERE / "configs" / "tgn-wiki" / "config.json").read_text())
    assert (tgn["memory_dim"], tgn["embedding_dim"], tgn["time_dim"], tgn["num_heads"],
            tgn["num_neighbors"], tgn["edge_dim"]) == (100, 100, 100, 2, 10, 172)
    dyg = json.loads((HERE / "configs" / "dygformer-wiki" / "config.json").read_text())
    assert (dyg["channel_embedding_dim"] * dyg["num_channels"], dyg["num_layers"],
            dyg["num_heads"], dyg["ffn_dim"], dyg["max_input_sequence_length"],
            dyg["num_neighbors"], dyg["output_dim"], dyg["node_feat_dim"]) == (
                200, 2, 2, 800, 32, 31, 172, 172)
