"""The port's TGN model pieces against the JAX package's, under one set of weights.

Each JAX module is initialised from a ``PRNGKey``; ``tgm_tpu_torch.weights``
loads its parameter tree into the port's module. Inputs come from numpy with
a seed. Tolerances: integer state exact; floats ``atol=1e-5`` (fp32, the two
frameworks sum in different orders); the weight round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.eval.metrics import mrr_per_edge as j_mrr_per_edge
from tgm_tpu.eval.metrics import mrr_sum_count as j_mrr_sum_count
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbeddingRowwise as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import tgn_store_messages as j_store
from tgm_tpu.nn.modules.gru import TorchGRUCell as JGRU
from tgm_tpu.nn.modules.time_encoding import Time2Vec as JTime2Vec
from tgm_tpu.ops.segment import segment_max as j_segment_max
from tgm_tpu_torch.eval import mrr, mrr_per_edge, mrr_sum_count
from tgm_tpu_torch.exceptions import BadAggregatorProtocolError
from tgm_tpu_torch.nn import (
    GraphAttentionEmbeddingRowwise,
    LinkPredictor,
    TGNMemory,
    TGNMemoryState,
    Time2Vec,
    TorchGRUCell,
    tgn_store_messages,
)
from tgm_tpu_torch.ops import segment_max
from tgm_tpu_torch.weights import load_tgn_params
from tools.refbridge import dense_params, gru_params, link_predictor_params, time2vec_params

N, M, RAW, T, K, S = 20, 12, 6, 8, 5, 14
ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def jax_models():
    memory = JMemory(num_nodes=N, raw_msg_dim=RAW, memory_dim=M, time_dim=T)
    encoder = JAttn(in_channels=M, out_channels=M, msg_dim=RAW, time_dim=T, dropout=0.0)
    decoder = JLinkPredictor(node_dim=M, hidden_dim=M)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    params = {
        "mem": memory.init(k1, memory.init_state(), jnp.zeros(4, jnp.int32)),
        "enc": encoder.init(k2, jnp.zeros((2, M)), jnp.zeros((2, K, M)), jnp.zeros(2, jnp.int32),
                            jnp.zeros((2, K), jnp.int32), jnp.zeros((2, K, RAW)),
                            jnp.ones((2, K), bool)),
        "dec": decoder.init(k3, jnp.zeros((1, M)), jnp.zeros((1, M))),
    }
    return memory, encoder, decoder, params


def port_models(params):
    mods = (TGNMemory(N, RAW, M, T), GraphAttentionEmbeddingRowwise(M, M, RAW, T, dropout=0.0),
            LinkPredictor(node_dim=M, hidden_dim=M))
    load_tgn_params(params, *mods)
    return [m.eval() for m in mods]


def stored_state(memory, params, seed=0):
    """A JAX memory state after two store+flush rounds (ties, invalid rows)."""
    rng = np.random.default_rng(seed)
    state = memory.init_state()
    for _ in range(2):
        E = 16
        src = jnp.asarray(rng.integers(0, N, E), jnp.int32)
        dst = jnp.asarray(rng.integers(0, N, E), jnp.int32)
        tt = jnp.asarray(np.sort(rng.integers(10, 20, E)), jnp.int32)
        raw = jnp.asarray(rng.normal(size=(E, RAW)), jnp.float32)
        valid = jnp.asarray(rng.random(E) < 0.85)
        state = j_store(state, src, dst, tt, raw, valid)
        state = memory.apply(params["mem"], state, jnp.arange(N), method="flush")
    # Leave one round of pending messages in the stores.
    state = j_store(state, src, dst, tt + 15, raw * 2, valid)
    return state


def to_port_state(j_state):
    return TGNMemoryState(*(t(x) for x in j_state))


def test_time2vec_matches_jax():
    dts = np.concatenate([np.arange(0, 50), np.random.default_rng(0).integers(0, 5000, 40)])
    mod = JTime2Vec(time_dim=T)
    p = mod.init(jax.random.PRNGKey(0), jnp.zeros(3))
    want = mod.apply(p, jnp.asarray(dts, jnp.float32))
    port = Time2Vec(T)
    close(port(t(dts.astype(np.float32))), want)  # the log-spaced init is the same
    # Random weights loaded through the weights module's Time2Vec mapping.
    p = {"params": {"w": jax.random.normal(jax.random.PRNGKey(1), (1, T)) * 0.01,
                    "b": jax.random.normal(jax.random.PRNGKey(2), (T,))}}
    with torch.no_grad():
        port.w.weight.copy_(t(p["params"]["w"]).T)
        port.w.bias.copy_(t(p["params"]["b"]))
    close(port(t(dts.astype(np.float32))), mod.apply(p, jnp.asarray(dts, jnp.float32)))


def test_gru_matches_jax():
    rng = np.random.default_rng(1)
    h, x = rng.normal(size=(9, M)).astype(np.float32), rng.normal(size=(9, 7)).astype(np.float32)
    mod = JGRU(features=M)
    p = mod.init(jax.random.PRNGKey(4), jnp.asarray(h), jnp.asarray(x))
    want, _ = mod.apply(p, jnp.asarray(h), jnp.asarray(x))
    cell = TorchGRUCell(7, M)
    g = p["params"]
    with torch.no_grad():
        for name, key, tr in (("weight_ih", "wi", True), ("bias_ih", "bi", False),
                              ("weight_hh", "wh", True), ("bias_hh", "bh", False)):
            getattr(cell, name).copy_(t(g[key]).T if tr else t(g[key]))
    got, same = cell(t(h), t(x))
    close(got, want)
    assert got is same
    # The gates are torch.nn.GRUCell's: same result as its own forward.
    close(torch.nn.GRUCell.forward(cell, t(x), t(h)), want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_segment_max_matches_jax(with_mask):
    rng = np.random.default_rng(2)
    data = rng.integers(-50, 50, 30).astype(np.int32)
    ids = rng.integers(0, 7, 30).astype(np.int32)
    mask = rng.random(30) < 0.6 if with_mask else None
    got = segment_max(t(data), t(ids), 9, mask=None if mask is None else t(mask), initial=-99)
    want = j_segment_max(jnp.asarray(data), jnp.asarray(ids), 9,
                         mask=None if mask is None else jnp.asarray(mask), initial=-99)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_store_messages_matches_jax():
    rng = np.random.default_rng(3)
    memory, _, _, params = jax_models()
    j_state = stored_state(memory, params)
    E = 24
    src = rng.integers(0, 8, E).astype(np.int32)  # few nodes: many per-node duplicates
    dst = rng.integers(0, 8, E).astype(np.int32)
    tt = np.sort(rng.integers(40, 44, E)).astype(np.int32)  # max-time ties
    raw = rng.normal(size=(E, RAW)).astype(np.float32)
    valid = rng.random(E) < 0.8
    want = j_store(j_state, *(jnp.asarray(x) for x in (src, dst, tt, raw, valid)))
    state = to_port_state(j_state)
    got = tgn_store_messages(state, *(t(x) for x in (src, dst, tt, raw, valid)))
    assert got.s_other is state.s_other  # updated in place
    for name in TGNMemoryState._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_memory_stage_flush_flush_all_match_jax():
    memory, _, _, params = jax_models()
    port = port_models(params)[0]
    j_state = stored_state(memory, params)
    nids = jnp.asarray([0, 3, 3, 7, -1, N, N + 4, 11, 19], jnp.int32)
    for training in (True, False):
        w_mem, w_last = memory.apply(params["mem"], j_state, nids, training, method="stage")
        g_mem, g_last = port.stage(to_port_state(j_state), t(nids), training=training)
        close(g_mem, w_mem)
        np.testing.assert_array_equal(g_last.numpy(), np.asarray(w_last))
    assert not np.allclose(np.asarray(w_mem), 0)

    want = memory.apply(params["mem"], j_state, nids, method="flush")
    got = port.flush(to_port_state(j_state), t(nids))
    close(got.mem, want.mem)
    np.testing.assert_array_equal(got.last_update.numpy(), np.asarray(want.last_update))

    want = memory.apply(params["mem"], j_state, method="flush_all")
    got = port.flush_all(to_port_state(j_state))
    for name in TGNMemoryState._fields:
        if name == "mem":
            close(got.mem, want.mem)
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("layout", ["lanesv", "kmajor"])
def test_rowwise_attention_matches_jax_layouts(layout):
    rng = np.random.default_rng(4)
    _, _, _, params = jax_models()
    encoder = JAttn(in_channels=M, out_channels=M, msg_dim=RAW, time_dim=T, dropout=0.0,
                    score_layout=layout)
    port = port_models(params)[1]
    x_seed = rng.normal(size=(S, M)).astype(np.float32)
    x_nbr = rng.normal(size=(S, K, M)).astype(np.float32)
    last = rng.integers(50, 100, S).astype(np.int32)
    nbr_t = rng.integers(0, 50, (S, K)).astype(np.int32)
    msg = rng.normal(size=(S, K, RAW)).astype(np.float32)
    valid = rng.random((S, K)) < 0.6
    valid[0] = False  # a seed without neighbours
    args = (x_seed, x_nbr, last, nbr_t, msg, valid)
    want = encoder.apply(params["enc"], *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = port(*(t(a) for a in args))
    close(got, want)


def test_link_predictor_and_metrics_match_jax():
    rng = np.random.default_rng(5)
    _, _, decoder, params = jax_models()
    port = port_models(params)[2]
    zs, zd = rng.normal(size=(2, 30, M)).astype(np.float32)
    want = decoder.apply(params["dec"], jnp.asarray(zs), jnp.asarray(zd))
    with torch.no_grad():
        got = port(t(zs), t(zd))
    close(got, want)
    with pytest.raises(BadAggregatorProtocolError):
        LinkPredictor(node_dim=M, merge_op=object())

    # TGB MRR with exact ties and masks.
    pos = rng.integers(0, 4, 10).astype(np.float32)
    neg = rng.integers(0, 4, (10, 6)).astype(np.float32)
    neg_valid = rng.random((10, 6)) < 0.8
    edge_valid = np.arange(10) < 8
    np.testing.assert_array_equal(
        mrr_per_edge(t(pos), t(neg), t(neg_valid)).numpy(),
        np.asarray(j_mrr_per_edge(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(neg_valid))))
    s, c = mrr_sum_count(t(pos), t(neg), t(neg_valid), t(edge_valid))
    js, jc = j_mrr_sum_count(*(jnp.asarray(x) for x in (pos, neg, neg_valid, edge_valid)))
    close(s, js)
    assert float(c) == float(jc) == 8
    close(mrr(t(pos), t(neg), t(neg_valid), t(edge_valid)), js / jc)


def test_weights_round_trip_through_refbridge():
    """torch -> flax tree (the reference bridge's mapping) -> torch is exact."""
    torch.manual_seed(0)
    src = (TGNMemory(N, RAW, M, T), GraphAttentionEmbeddingRowwise(M, M, RAW, T),
           LinkPredictor(node_dim=M, hidden_dim=M))
    mem, enc, dec = src
    tree = {
        "mem": {"params": {"time_enc": time2vec_params(mem.time_enc), "gru": gru_params(mem.gru)}},
        "enc": {"params": {"time_enc": time2vec_params(enc.time_enc),
                           **{n: dense_params(getattr(enc, n))
                              for n in ("lin_query", "lin_key", "lin_value", "lin_edge", "lin_skip")}}},
        "dec": link_predictor_params(dec),
    }
    torch.manual_seed(1)
    dst = (TGNMemory(N, RAW, M, T), GraphAttentionEmbeddingRowwise(M, M, RAW, T),
           LinkPredictor(node_dim=M, hidden_dim=M))
    load_tgn_params(tree, *dst)
    for a, b in zip(src, dst):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    bad = dict(tree, dec={"params": {"mlp": {"Dense_0": tree["dec"]["params"]["mlp"]["Dense_0"]}}})
    with pytest.raises(ValueError):
        load_tgn_params(bad, *dst)
