"""The TGN train step, piece by piece, against the JAX package on the CPU.

* ``RandomNegativeEdgeSamplerHook``: range [low, high), PAD on padded rows,
  ``neg_time`` / ``neg_valid``, sizes by ``neg_ratio`` (as the JAX hook), the
  injection point and re-seeding.
* ``bce_with_logits`` against the JAX one on masked logits (atol 1e-6).
* ``tgn_commit_staged`` against JAX (integer fields exact, ``mem`` 1e-6).
* ``torch.optim.Adam`` against ``optax.adam`` on a small tree over 5 steps
  (1e-6), a leaf with a zero gradient included.
* One ``train_core`` step against the JAX rowwise ``train_core`` on the same
  hook-enriched batch and memory state, with ``optax.sgd(1.0)`` and
  ``torch.optim.SGD(lr=1.0)``, so the weight change is the gradient: every
  leaf within 1e-5 (compared through ``load_tgn_params``), the loss within
  1e-6, the committed state's integer fields exact and its floats within
  1e-5.
* ``eval_core`` is deterministic whatever the modules' train/eval mode.

Sizes: 120 nodes, 800 edges, batch 100, K = 10, memory/time/embed dims
16/8/16, 8-dim edge features, made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.core.batch import DGBatch as JDGBatch
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbeddingRowwise as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import TGNMemoryState as JState
from tgm_tpu.nn.encoder.tgn import tgn_commit_staged as j_commit_staged
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train.programs import bce_with_logits as j_bce
from tgm_tpu.train.programs import build_tgn_hook_cores as j_build_cores
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks import (
    HookManager,
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from tgm_tpu_torch.nn import (
    GraphAttentionEmbeddingRowwise,
    LinkPredictor,
    TGNMemory,
    TGNMemoryState,
    tgn_commit_staged,
)
from tgm_tpu_torch.train import DeviceEdgeStream, bce_with_logits, build_tgn_hook_cores, hook_epoch
from tgm_tpu_torch.weights import load_tgn_params

N, E, BSIZE, K, MEM, TIME, EMB, EDGE_DIM = 120, 800, 100, 10, 16, 8, 16, 8
STATE_FIELDS = ("mem", "last_update", "s_other", "s_t", "s_raw", "s_valid",
                "d_other", "d_t", "d_raw", "d_valid")
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    return src, dst, t, edge_x, rng


def jax_modules(dropout=0.0):
    return (JMemory(num_nodes=N, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME),
            JAttn(in_channels=MEM, out_channels=EMB, msg_dim=EDGE_DIM, time_dim=TIME,
                  dropout=dropout),
            JLinkPredictor(node_dim=EMB, hidden_dim=EMB))


def port_modules(dropout=0.0):
    return (TGNMemory(N, EDGE_DIM, MEM, TIME),
            GraphAttentionEmbeddingRowwise(MEM, EMB, EDGE_DIM, TIME, dropout=dropout),
            LinkPredictor(node_dim=EMB, hidden_dim=EMB))


def jax_params(memory, encoder, decoder, seed=7):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "mem": memory.init(k1, memory.init_state(), jnp.zeros(8, jnp.int32)),
        "enc": encoder.init(
            k2, jnp.zeros((4, MEM)), jnp.zeros((4, 3, MEM)), jnp.zeros(4, jnp.int32),
            jnp.zeros((4, 3), jnp.int32), jnp.zeros((4, 3, EDGE_DIM)), jnp.ones((4, 3), bool),
        ),
        "dec": decoder.init(k3, jnp.zeros((1, EMB)), jnp.zeros((1, EMB))),
    }


def random_state(rng, n_rows, t_max):
    """A memory state with pending messages on most rows; the dump row pristine."""
    n = n_rows - 1
    last = rng.integers(0, t_max // 2, n_rows).astype(np.int32)
    st = dict(
        mem=rng.normal(scale=0.5, size=(n_rows, MEM)).astype(np.float32),
        last_update=last,
        s_other=rng.integers(-1, n, n_rows).astype(np.int32),
        s_t=(last + rng.integers(0, t_max // 2, n_rows)).astype(np.int32),
        s_raw=rng.normal(size=(n_rows, EDGE_DIM)).astype(np.float32),
        s_valid=rng.random(n_rows) < 0.7,
        d_other=rng.integers(-1, n, n_rows).astype(np.int32),
        d_t=(last + rng.integers(0, t_max // 2, n_rows)).astype(np.int32),
        d_raw=rng.normal(size=(n_rows, EDGE_DIM)).astype(np.float32),
        d_valid=rng.random(n_rows) < 0.7,
    )
    for name, fill in (("mem", 0), ("last_update", 0), ("s_other", -1), ("s_t", 0), ("s_raw", 0),
                       ("s_valid", False), ("d_other", -1), ("d_t", 0), ("d_raw", 0),
                       ("d_valid", False)):
        st[name][n] = fill
    return st


def to_jax_state(st):
    return JState(**{k: jnp.asarray(v) for k, v in st.items()})


def to_port_state(st):
    return TGNMemoryState(**{k: torch.from_numpy(np.array(v)) for k, v in st.items()})


def assert_state_close(got, want, atol):
    for name in STATE_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------- #
# RandomNegativeEdgeSamplerHook
# ---------------------------------------------------------------------- #
def _batch(B, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    valid = np.arange(B) < n_valid
    src = np.where(valid, rng.integers(0, 50, B), -1).astype(np.int32)
    dst = np.where(valid, rng.integers(0, 50, B), -1).astype(np.int32)
    t = np.where(valid, np.sort(rng.integers(0, 1000, B)), 0).astype(np.int32)
    return src, dst, t, valid


def test_random_negatives_range_pad_and_times():
    src, dst, t, valid = _batch(4000, 3000)
    hook = RandomNegativeEdgeSamplerHook(low=3, high=7, device="cpu", seed=5)
    state = hook.init_state()
    _, b = hook.apply(state, DGBatch(*(torch.from_numpy(x) for x in (src, dst, t, valid))))
    neg = b.neg.numpy()
    assert neg.dtype == np.int32 and neg.shape == (4000,)
    live = neg[valid]
    assert live.min() == 3 and live.max() == 6  # high is exclusive
    assert set(np.unique(live)) == {3, 4, 5, 6}
    np.testing.assert_array_equal(neg[~valid], -1)
    np.testing.assert_array_equal(b.neg_time.numpy(), t)
    np.testing.assert_array_equal(b.neg_valid.numpy(), valid)
    assert hook.produces == {"neg", "neg_time"}


@pytest.mark.parametrize("ratio, B", [(1.0, 10), (0.5, 7), (0.5, 5), (0.3, 10), (0.01, 7)])
def test_random_negatives_sizes_match_the_jax_hook(ratio, B):
    src, dst, t, valid = _batch(B, B - 2, seed=1)
    jhook = JRandomNeg(low=0, high=50, neg_ratio=ratio)
    _, jb = jhook.apply(jax.random.PRNGKey(0), JDGBatch(
        edge_src=jnp.asarray(src), edge_dst=jnp.asarray(dst), edge_time=jnp.asarray(t),
        edge_valid=jnp.asarray(valid)))
    hook = RandomNegativeEdgeSamplerHook(low=0, high=50, neg_ratio=ratio, device="cpu")
    _, b = hook.apply(hook.init_state(), DGBatch(*(torch.from_numpy(x)
                                                   for x in (src, dst, t, valid))))
    assert b.neg.shape == jb.neg.shape == (max(1, round(ratio * B)),)
    np.testing.assert_array_equal(b.neg_time.numpy(), np.asarray(jb.neg_time))
    np.testing.assert_array_equal(b.neg_valid.numpy(), np.asarray(jb.neg_valid))
    np.testing.assert_array_equal(b.neg.numpy() == -1, np.asarray(jb.neg) == -1)


def test_random_negatives_injection_and_reseeding():
    src, dst, t, valid = _batch(20, 15, seed=2)
    batch = lambda: DGBatch(*(torch.from_numpy(x) for x in (src, dst, t, valid)))
    hm = HookManager(keys=["train"])
    hook = RandomNegativeEdgeSamplerHook(low=0, high=1000, device="cpu", seed=3)
    hm.register("train", hook)
    fn, states = hm.as_transform("train", None)
    first = [fn(states, batch())[1].neg.clone() for _ in range(2)]
    assert not torch.equal(first[0], first[1])  # the generator advances
    hm.reset_state()
    fn, states = hm.as_transform("train", None)
    again = [fn(states, batch())[1].neg for _ in range(2)]
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    hook.draw_neg = lambda size: torch.arange(size, dtype=torch.int32) + 500
    neg = fn(states, batch())[1].neg.numpy()
    np.testing.assert_array_equal(neg, np.where(valid, np.arange(20) + 500, -1))
    with pytest.raises(ValueError):
        RandomNegativeEdgeSamplerHook(low=5, high=5, device="cpu")
    with pytest.raises(ValueError):
        RandomNegativeEdgeSamplerHook(low=0, high=5, neg_ratio=1.5, device="cpu")


# ---------------------------------------------------------------------- #
# Loss, commit, optimizer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n_valid", [0, 37, 64])
def test_bce_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    logits = (rng.normal(size=64) * 8).astype(np.float32)
    logits[:3] = [40.0, -40.0, 0.0]
    mask = rng.permutation(np.arange(64) < n_valid)
    for target in (np.ones(64, np.float32), np.zeros(64, np.float32)):
        want = float(j_bce(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask)))
        got = float(bce_with_logits(torch.from_numpy(logits), torch.from_numpy(target),
                                    torch.from_numpy(mask)))
        assert abs(got - want) <= 1e-6, (got, want)


def test_commit_staged_matches_jax():
    rng = np.random.default_rng(4)
    st = random_state(rng, N + 1, 1000)
    # 2B nodes with duplicates and invalid ids (-1, N, beyond N); a node's
    # duplicates carry equal staged rows, as the forward stages them.
    nodes = rng.integers(0, N, 200).astype(np.int32)
    nodes[rng.random(200) < 0.1] = -1
    nodes[:3] = [N, N + 5, -1]
    per_node_mem = rng.normal(size=(N + 6, MEM)).astype(np.float32)
    per_node_last = rng.integers(0, 2000, N + 6).astype(np.int32)
    st_mem, st_last = per_node_mem[nodes], per_node_last[nodes]
    want = j_commit_staged(to_jax_state(st), jnp.asarray(nodes), jnp.asarray(st_mem),
                           jnp.asarray(st_last))
    got = tgn_commit_staged(to_port_state(st), torch.from_numpy(nodes),
                            torch.from_numpy(st_mem).requires_grad_(), torch.from_numpy(st_last))
    assert not got.mem.requires_grad
    assert_state_close(got, want, atol=1e-6)
    assert float(got.mem[N].abs().max()) == 0.0 and int(got.last_update[N]) == 0


def test_adam_matches_optax_over_five_steps():
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 4), "b": (4,), "gru": (3, 5), "still": (2,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    for g in grads[1:]:  # a leaf whose gradient is 0 after the first step
        g["still"][:] = 0.0
    opt = optax.adam(1e-3)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = opt.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    t_opt = torch.optim.Adam(t_params.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, j_state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state)
        j_params = optax.apply_updates(j_params, upd)
        t_opt.zero_grad(set_to_none=False)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        t_opt.step()
    for k in shapes:
        np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(j_params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    # The zero-gradient leaf still moved on steps 2-5 (the moments decay).
    assert np.abs(t_params["still"].detach().numpy() - init["still"]).max() > 1e-4


# ---------------------------------------------------------------------- #
# One train step
# ---------------------------------------------------------------------- #
def jax_enriched_batch(src, dst, t, edge_x, index):
    """Batch ``index`` (modulo the batch count) of the train split through
    the JAX random-negative and recency hooks, after the batches before it
    were pushed."""
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    train, _, _ = data.split()
    dg = JDGraph(train)
    hm = JHookManager(keys=["train"])
    hm.register("train", JRandomNeg(low=0, high=N))
    hm.register_shared(JRecency(N, [K], ["edge_src", "edge_dst", "neg"],
                                ["edge_time", "edge_time", "neg_time"],
                                edge_dim=EDGE_DIM, edge_x_full=data.edge_x))
    stream = JStream(dg, BSIZE)
    fn, states = hm.as_transform("train", dg)
    fn = jax.jit(fn)
    for i in range(index % stream.num_batches + 1):
        states, batch = fn(states, stream.batch_at(i))
    return batch


def port_batch(jb):
    up = lambda x: torch.from_numpy(np.array(x))
    return DGBatch(up(jb.edge_src), up(jb.edge_dst), up(jb.edge_time), up(jb.edge_valid),
                   edge_x=up(jb.edge_x), neg=up(jb.neg), seed_nids=[up(jb.seed_nids[0])],
                   nbr_nids=[up(jb.nbr_nids[0])], nbr_edge_time=[up(jb.nbr_edge_time[0])],
                   nbr_edge_x=[up(jb.nbr_edge_x[0])])


def test_one_train_step_matches_jax_train_core():
    src, dst, t, edge_x, rng = make_stream(0)
    jb = jax_enriched_batch(src, dst, t, edge_x, -1)  # the padded tail batch
    assert not np.asarray(jb.edge_valid).all() and np.asarray(jb.edge_valid).any()
    st = random_state(rng, N + 1, int(t.max()))

    jmods = jax_modules()
    params = jax_params(*jmods)
    opt = optax.sgd(1.0)
    j_train, _ = j_build_cores(*jmods, opt, N, style="rowwise")
    (j_params, _, j_state, _), j_loss = jax.jit(j_train)(
        (params, opt.init(params), to_jax_state(st), jax.random.PRNGKey(0)), jb)

    mods = port_modules()
    load_tgn_params(params, *mods)
    t_opt = torch.optim.SGD([p for m in mods for p in m.parameters()], lr=1.0)
    train_core, _ = build_tgn_hook_cores(*mods, t_opt, N, style="rowwise")
    (state, gen), loss = train_core((to_port_state(st), None), port_batch(jb))
    assert gen is None and not loss.requires_grad

    assert abs(float(loss) - float(j_loss)) <= 1e-6, (float(loss), float(j_loss))
    want = port_modules()
    load_tgn_params(j_params, *want)
    for m, w, name in zip(mods, want, ("mem", "enc", "dec")):
        for (k, p), (_, q) in zip(m.named_parameters(), w.named_parameters()):
            diff = float((p - q).detach().abs().max())
            assert diff <= 1e-5, (name, k, diff)
    # Every leaf had a non-zero gradient: the comparison is not of unchanged weights.
    moved = jax.tree_util.tree_map(lambda a, b: bool(np.any(np.asarray(a) != np.asarray(b))),
                                   j_params, params)
    assert all(jax.tree_util.tree_leaves(moved))
    assert_state_close(state, j_state, atol=1e-5)
    assert not np.array_equal(state.mem.numpy(), st["mem"])  # the commit wrote rows


def test_train_core_without_an_optimizer_raises():
    src, dst, t, edge_x, rng = make_stream(0)
    jb = jax_enriched_batch(src, dst, t, edge_x, 1)
    train_core, _ = build_tgn_hook_cores(*port_modules(), None, N, style="rowwise")
    st = to_port_state(random_state(rng, N + 1, int(t.max())))
    with pytest.raises(ValueError, match="optimizer"):
        train_core((st, None), port_batch(jb))


# ---------------------------------------------------------------------- #
# eval_core does not depend on the modules' mode
# ---------------------------------------------------------------------- #
def test_eval_core_is_deterministic_in_train_mode():
    src, dst, t, edge_x, rng = make_stream(1)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, _ = data.split()
    dg = DGraph(val)
    cands = rng.integers(0, N, (dg.num_edge_events, 5))
    mods = port_modules(dropout=0.5)
    st = random_state(rng, N + 1, int(t.max()))
    sums = {}
    for mode in ("train", "eval"):
        for m in mods:
            m.train(mode == "train")
        hm = HookManager(keys=["val"])
        hm.register("val", TGBNegativeEdgeSamplerHook(cands, device="cpu", seed=1))
        hm.register_shared(RecencyNeighborHook(N, [K], ["edge_src", "edge_dst", "neg"],
                                               ["edge_time", "edge_time", "neg_time"],
                                               edge_dim=EDGE_DIM, edge_x_full=data.edge_x,
                                               device="cpu"))
        _, eval_core = build_tgn_hook_cores(*mods, None, N, style="rowwise")
        epoch, states = hook_epoch(DeviceEdgeStream(dg, BSIZE, device="cpu"), hm, "val", dg,
                                   eval_core)
        _, _, (s, c) = epoch(to_port_state(st), states)
        sums[mode] = s
    assert mods[1].training is False
    torch.testing.assert_close(sums["train"], sums["eval"], rtol=0, atol=0)
    assert float(sums["eval"].sum()) > 0


def test_attention_dropout_follows_the_generator():
    """Dropout on the attention weights is drawn from the given generator only:
    the same seed gives the same output, no generator gives none, and the kept
    weights are scaled by 1 / (1 - p), as flax ``nn.Dropout``."""
    from tgm_tpu_torch.nn.encoder.tgn import _dropout

    rng = np.random.default_rng(6)
    S = 64
    args = (torch.from_numpy(rng.normal(size=(S, MEM)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(S, K, MEM)).astype(np.float32)),
            torch.from_numpy(rng.integers(100, 200, S).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 100, (S, K)).astype(np.int32)),
            torch.from_numpy(rng.normal(size=(S, K, EDGE_DIM)).astype(np.float32)),
            torch.from_numpy(rng.random((S, K)) < 0.8))
    enc = port_modules(dropout=0.3)[1].train()
    gen = lambda: torch.Generator().manual_seed(11)
    plain = enc(*args)
    torch.testing.assert_close(enc(*args), plain, rtol=0, atol=0)  # train mode, no generator
    a, b = enc(*args, generator=gen()), enc(*args, generator=gen())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - plain).detach().abs().max()) > 1e-3
    x = torch.rand(20000) + 0.5
    y = _dropout(x, 0.3, gen())
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    assert float(_dropout(x, 1.0, gen()).abs().max()) == 0.0
    assert _dropout(x, 0.0, gen()) is x
