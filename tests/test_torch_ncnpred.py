"""The NCN decoder and TNCN's train step against the JAX package on the CPU.

* ``_dense_adj`` and ``ncn_adjacency_rows`` bit-exact against JAX, with
  duplicate and PAD seeds; on seed lists whose tail is unique, as the eval
  seeds are, also against JAX's ``ncn_adjacency_rows_blocked`` (the JAX
  example's eval builder).
* ``NCNPredictor`` (same weights, JAX's init) within 1e-5 * max(1, max |score|)
  over k in {2, 4, 8} x time decay on two seeds; ``score_from_rows``
  against JAX's and against the port's ``forward`` on a (seed, neighbour)
  graph; the errors JAX raises.
* The TNCN example's train loss (``build_tncn_cores``' ``loss_and_grad``)
  at k = 2 and 4 on a memory with pending messages, PAD seeds, a seed
  without neighbours and duplicate neighbour ids: the loss within 1e-5 *
  max(1, |loss|), the gradients of every parameter within 1e-4 * max |g|
  per leaf (at least 1e-3 of the largest leaf), against the JAX example's
  table path.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.hooks import map_to_local as j_local
from tgm_tpu.nn import NCNPredictor as JNCN
from tgm_tpu.nn.decoder import ncnpred as jn
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbedding as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import tgn_store_messages as j_store
from tgm_tpu_torch.examples.linkproppred.tncn import build_tncn_cores
from tgm_tpu_torch.nn import GraphAttentionEmbedding, NCNPredictor, TGNMemory, TGNMemoryState
from tgm_tpu_torch.nn.decoder import ncnpred as pn
from tgm_tpu_torch.weights import _dense, load_tncn_params


def t(a):
    return torch.from_numpy(np.array(a))


def seed_graph(rng, U, B, Q, K, unique_tail):
    """Seeds [head (2B, duplicates and PAD) ‖ tail (Q, unique, then PAD)] and
    their (S, K) neighbour slots, some PAD, some masked off."""
    head = rng.integers(-1, U, 2 * B)
    head[1] = head[0]
    tail = rng.permutation(U)[:Q] if unique_tail else rng.integers(-1, U, Q)
    seeds = np.concatenate([head, tail, [-1, -1]]).astype(np.int32)
    nbrs = rng.integers(-1, U, (len(seeds), K)).astype(np.int32)
    nbrs[:, -1] = nbrs[:, 0]
    ok = (nbrs >= 0) & (seeds[:, None] >= 0)
    ok &= rng.random(ok.shape) < 0.9
    return seeds, nbrs, ok


@pytest.mark.parametrize("seed", range(6))
def test_adjacency_rows_are_bit_exact(seed):
    rng = np.random.default_rng(seed)
    U, B, Q, K = 30 + seed, 4, 12, 3
    for unique_tail in (False, True):
        seeds, nbrs, ok = seed_graph(rng, U, B, Q, K, unique_tail)
        args = (seeds, nbrs, ok)
        want = np.asarray(jn.ncn_adjacency_rows(*map(jnp.asarray, args), U))
        got = pn.ncn_adjacency_rows(*map(t, args), U).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.max() > 1  # duplicate slots and seeds add up
        if unique_tail:
            want_b = np.asarray(jn.ncn_adjacency_rows_blocked(*map(jnp.asarray, args), U,
                                                              2 * B))
            np.testing.assert_array_equal(got, want_b)
    src, dst = rng.integers(-1, U, (2, 50)).astype(np.int32)
    valid = rng.random(50) < 0.8
    for v in (valid, None):
        want = np.asarray(jn._dense_adj(jnp.asarray(src), jnp.asarray(dst), U,
                                        None if v is None else jnp.asarray(v)))
        got = pn._dense_adj(t(src), t(dst), U, None if v is None else t(v)).numpy()
        np.testing.assert_array_equal(got, want)


U, D, B = 24, 8, 10


def ncn_case(rng):
    x = rng.normal(size=(U, D)).astype(np.float32)
    src, dst = rng.integers(-1, U, (2, 60)).astype(np.int32)
    valid = (src >= 0) & (dst >= 0) & (rng.random(60) < 0.9)
    tar_i = rng.integers(0, U, B).astype(np.int32)
    tar_j = rng.integers(-1, U, B).astype(np.int32)
    tar_i[1], tar_j[2] = tar_i[0], tar_j[3]  # duplicate query rows
    last = rng.integers(0, 20_000, U).astype(np.int32)
    times = rng.integers(20_000, 40_000, B).astype(np.int32)
    return x, src, dst, tar_i, tar_j, last, times, valid


def ncn_pair(k, decay, seed=0):
    kw = dict(k=k, cn_time_decay=decay)
    jm = JNCN(in_channels=D, hidden_dim=D, out_channels=1, **kw)
    case = ncn_case(np.random.default_rng(seed))
    params = jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, case))
    port = NCNPredictor(D, D, 1, **kw)
    with torch.no_grad():
        _dense(port.xsmlp[0], params["params"]["xsmlp"]["layers_0"])
        _dense(port.xsmlp[2], params["params"]["xsmlp"]["layers_2"])
    return jm, params, port, case


def assert_scores_close(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, err


@pytest.mark.parametrize("k,decay,seed", [(2, False, 0), (2, True, 0), (4, False, 0),
                                          (4, True, 0), (8, False, 0), (8, True, 0),
                                          (2, False, 2), (4, True, 2)])
def test_predictor_matches_jax(k, decay, seed):
    jm, params, port, case = ncn_pair(k, decay, seed)
    want = np.asarray(jm.apply(params, *map(jnp.asarray, case)))
    with torch.no_grad():
        got = port(*map(t, case)).numpy()
    assert got.shape == (B,)
    assert_scores_close(got, want)


@pytest.mark.parametrize("k,decay", [(2, False), (4, True), (2, True), (4, False)])
def test_score_from_rows_matches_jax_and_forward(k, decay):
    jm, params, port, case = ncn_pair(k, decay, seed=1)
    x, last = case[0], case[5]
    rng = np.random.default_rng(5)
    seeds = rng.permutation(U)[: 2 * B].astype(np.int32)
    nbrs = rng.integers(-1, U, (2 * B, 4)).astype(np.int32)
    ok = nbrs >= 0
    rows = pn.ncn_adjacency_rows(t(seeds), t(nbrs), t(ok), U)
    tar_i, tar_j, times = seeds[:B], seeds[B:], case[6]
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(rows[:B].numpy()),
                               jnp.asarray(rows[B:].numpy()), tar_i, tar_j, last, times,
                               method=JNCN.score_from_rows))
    with torch.no_grad():
        got = port.score_from_rows(t(x), rows[:B], rows[B:], t(tar_i), t(tar_j), t(last),
                                   t(times)).numpy()
        e_src, e_dst = np.repeat(seeds, 4), nbrs.reshape(-1)
        dense = port(t(x), t(e_src), t(e_dst), t(tar_i), t(tar_j), t(last), t(times),
                     t(ok.reshape(-1))).numpy()
    assert_scores_close(got, want)
    assert_scores_close(dense, got)


def test_predictor_raises_as_jax_does():
    with pytest.raises(ValueError, match="2,4,8"):
        NCNPredictor(D, D, 1, k=3)
    x, z = torch.zeros(U, D), torch.zeros(B, U)
    ids = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="k in"):
        NCNPredictor(D, D, 1, k=8).score_from_rows(x, z, z, ids, ids)
    with pytest.raises(RuntimeError, match="time info"):
        NCNPredictor(D, D, 1, k=2, cn_time_decay=True).score_from_rows(x, z, z, ids, ids)


# ---------------------------------------------------------------------- #
# TNCN's train scores through the example's core
# ---------------------------------------------------------------------- #
N, OB, K = 40, 6, 4
MEM_D, EMB_D, TIME_D, EDGE_D = 16, 16, 8, 5


def train_case(k):
    """A TNCN train batch on a memory with committed and pending messages:
    seeds [src ‖ dst ‖ neg] with PAD holes, duplicate neighbour values and a
    seed without neighbours, deduplicated as the hook does."""
    rng = np.random.default_rng(k)
    memory = JMemory(num_nodes=N, raw_msg_dim=EDGE_D, memory_dim=MEM_D, time_dim=TIME_D)
    encoder = JAttn(in_channels=MEM_D, out_channels=EMB_D, msg_dim=EDGE_D, time_dim=TIME_D,
                    dropout=0.0)
    decoder = JNCN(in_channels=EMB_D, hidden_dim=EMB_D, out_channels=1, k=k)
    mem_state = memory.init_state()

    @jax.jit
    def commit(p, state, src, dst, times, raw):
        state = memory.apply(p, state, jnp.concatenate([src, dst]), method=JMemory.flush)
        return j_store(state, src, dst, times, raw, jnp.ones(OB, bool))

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(k), 3)
    e4 = jnp.zeros(4, jnp.int32)
    params = {
        "mem": memory.init(k1, mem_state, jnp.zeros(4, jnp.int32)),
        "enc": encoder.init(k2, jnp.zeros((8, MEM_D)), jnp.zeros(8, jnp.int32), e4, e4, e4,
                            jnp.zeros((4, EDGE_D)), jnp.ones(4, bool)),
        "dec": decoder.init(k3, jnp.zeros((8, EMB_D)), e4, e4, jnp.zeros(2, jnp.int32),
                            jnp.zeros(2, jnp.int32), jnp.zeros(8, jnp.int32),
                            jnp.zeros(2, jnp.int32)),
    }
    t0 = 0
    for _ in range(4):
        src, dst = rng.integers(0, N, (2, OB)).astype(np.int32)
        times = np.sort(rng.integers(t0, t0 + 50, OB)).astype(np.int32)
        raw = rng.normal(size=(OB, EDGE_D)).astype(np.float32)
        mem_state = commit(params["mem"], mem_state, src, dst, times, raw)
        t0 += 50
    src, dst, neg = rng.integers(0, N, (3, OB)).astype(np.int32)
    src[-1] = dst[-1] = PADDED_NODE_ID
    seeds = np.concatenate([src, dst, neg])
    nbrs = rng.integers(0, N, (len(seeds), K)).astype(np.int32)
    nbrs[:, -1] = nbrs[:, 0]
    nbrs[2] = PADDED_NODE_ID
    ok = (nbrs != PADDED_NODE_ID) & (seeds[:, None] != PADDED_NODE_ID)
    nbrs = np.where(ok, nbrs, PADDED_NODE_ID).astype(np.int32)
    ids = np.concatenate([seeds, nbrs.reshape(-1)])
    distinct = np.unique(ids[ids >= 0])
    uniq = np.full(min(len(ids), N + 1), PADDED_NODE_ID, np.int32)
    uniq[: len(distinct)] = distinct
    g2l = np.full(N + 1, -1, np.int32)
    g2l[distinct] = np.arange(len(distinct), dtype=np.int32)
    batch = dict(edge_src=src, edge_dst=dst, neg=neg,
                 edge_time=rng.integers(250, 300, OB).astype(np.int32),
                 edge_valid=src != PADDED_NODE_ID, seed_nids=seeds, nbr_nids=nbrs,
                 nbr_edge_time=rng.integers(0, 250, nbrs.shape).astype(np.int32),
                 nbr_edge_x=rng.normal(size=nbrs.shape + (EDGE_D,)).astype(np.float32),
                 unique_nids=uniq, global_to_local=g2l)
    return (memory, encoder, decoder), params, mem_state, batch


def j_table_loss(mods, p, mem_state, b):
    """The JAX example's table train loss (examples/linkproppred/tncn.py):
    the memory staged over the unique nodes, the segment encoder over the
    (seed, neighbour) slots, the adjacency rows, ``score_from_rows``."""
    memory, encoder, decoder = mods
    g2l, seeds, nbrs = b["global_to_local"], b["seed_nids"], b["nbr_nids"]
    z_mem, last_upd = memory.apply(p["mem"], mem_state, b["unique_nids"], method=JMemory.stage)
    src_rep, nbr_flat = jnp.repeat(seeds, nbrs.shape[1]), nbrs.reshape(-1)
    e_valid = (nbr_flat != PADDED_NODE_ID) & (src_rep != PADDED_NODE_ID)
    z = encoder.apply(p["enc"], z_mem, last_upd, j_local(g2l, src_rep), j_local(g2l, nbr_flat),
                      b["nbr_edge_time"].reshape(-1),
                      b["nbr_edge_x"].reshape(nbr_flat.shape[0], -1), e_valid)
    ok = (nbrs != PADDED_NODE_ID) & (seeds[:, None] != PADDED_NODE_ID)
    rows = jn.ncn_adjacency_rows(j_local(g2l, seeds), j_local(g2l, nbrs), ok, z.shape[0])

    def score(dst, rows_j):
        return decoder.apply(p["dec"], z, rows[:OB], rows_j, j_local(g2l, b["edge_src"]),
                             j_local(g2l, dst), last_update=last_upd,
                             edge_time=b["edge_time"], method=JNCN.score_from_rows)

    pos, neg = score(b["edge_dst"], rows[OB : 2 * OB]), score(b["neg"], rows[2 * OB :])
    m = b["edge_valid"].astype(pos.dtype)
    return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
            + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)) * m)
            ) / jnp.maximum(m.sum(), 1.0)


def port_modules(k, params):
    mods = (TGNMemory(N, EDGE_D, MEM_D, TIME_D),
            GraphAttentionEmbedding(MEM_D, EMB_D, EDGE_D, TIME_D, dropout=0.0),
            NCNPredictor(EMB_D, EMB_D, 1, k=k))
    load_tncn_params(params, *mods)
    return mods


@pytest.mark.parametrize("k", [2, 4])
def test_table_train_loss_and_gradients_match_jax(k):
    mods_j, params, j_state, b = train_case(k)
    jb = {name: jnp.asarray(v) for name, v in b.items()}
    want, grads = jax.jit(jax.value_and_grad(lambda p: j_table_loss(mods_j, p, j_state, jb)))(
        params)

    mods = port_modules(k, params)
    opt = torch.optim.SGD([p for m in mods for p in m.parameters()], lr=0.0)
    train_core, _ = build_tncn_cores(*mods, opt, N)
    state = TGNMemoryState(**{f: t(v) for f, v in j_state._asdict().items()})
    pb = SimpleNamespace(**{name: t(v) for name, v in b.items()})
    for name in ("seed_nids", "nbr_nids", "nbr_edge_time", "nbr_edge_x"):
        setattr(pb, name, [getattr(pb, name)])
    loss = float(train_core.loss_and_grad(state, pb, None))
    assert abs(loss - float(want)) <= 1e-5 * max(1.0, abs(float(want))), (loss, float(want))

    ref = port_modules(k, grads)
    pairs = [(name, p.grad, q.detach()) for m, r in zip(mods, ref)
             for (name, p), q in zip(m.named_parameters(), r.parameters())]
    top = max(float(q.abs().max()) for _, _, q in pairs)
    worst = 0.0
    for name, g, q in pairs:
        err = float((g - q).abs().max()) / max(float(q.abs().max()), 1e-3 * top)
        worst = max(worst, err)
        assert err <= 1e-4, (name, err)
    print(f"k={k}: table-path loss gap {abs(loss - float(want)):.3g}, gradients within "
          f"{worst:.3g} * max |g| of JAX's")
