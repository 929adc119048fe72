"""The serving slice as a whole: JAX ``eval_core`` against the port's ``hook_epoch``.

A small stream (120 nodes, 800 edges, batch 100, 5 candidates per edge,
K = 10, dims 16) made with numpy from a seed runs through the val and test
splits on both packages, once with uniform node popularity and once with
the bench recipe's zipf popularity, where most candidate scores tie
exactly (the port scores positives and candidates in one decoder call, the
JAX code in two), on the CPU, with the same weights (JAX's init,
loaded into the port by ``tgm_tpu_torch.weights``) and the same candidates.
The TGB hook's fake link times come from each package's own generator, so
the port is fed the JAX hook's ``neg_time`` of each batch.

Tolerances: integer state exact; per-batch MRR sums within 1e-5 and memory
within atol 1e-5 (fp32, different summation orders of the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbeddingRowwise as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train.programs import build_tgn_hook_cores as j_build_cores
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TGBNegativeEdgeSamplerHook
from tgm_tpu_torch.nn import GraphAttentionEmbeddingRowwise, LinkPredictor, TGNMemory
from tgm_tpu_torch.train import DeviceEdgeStream, build_tgn_hook_cores, hook_epoch
from tgm_tpu_torch.weights import load_tgn_params

N, E, BSIZE, Q, K, DIM, EDGE_DIM = 120, 800, 100, 5, 10, 16, 8


def make_stream(popularity, seed=0):
    """Edges, times, features and a candidate-popularity vector (None: uniform).

    ``"zipf"`` is the repo's bench recipe (``zipf(1.4)`` popularity): nearly
    every edge lands on a few hot nodes, most nodes have no history, and many
    candidates are the positive's own node, so candidate scores tie exactly.
    """
    rng = np.random.default_rng(seed)
    pop = None
    if popularity == "zipf":
        pop = rng.zipf(1.4, size=N).astype(np.float64)
        pop /= pop.sum()
    src = rng.choice(N, E, p=pop)
    dst = rng.choice(N, E, p=pop)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))  # repeated times: ties inside batches
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    return src, dst, t, edge_x, rng, pop


def jax_params(memory, encoder, decoder):
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    state = memory.init_state()
    return {
        "mem": memory.init(k1, state, jnp.zeros(8, jnp.int32)),
        "enc": encoder.init(
            k2, jnp.zeros((4, DIM)), jnp.zeros((4, 3, DIM)), jnp.zeros(4, jnp.int32),
            jnp.zeros((4, 3), jnp.int32), jnp.zeros((4, 3, EDGE_DIM)), jnp.ones((4, 3), bool),
        ),
        "dec": decoder.init(k3, jnp.zeros((1, DIM)), jnp.zeros((1, DIM))),
    }


def run_jax(src, dst, t, edge_x, cands):
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    dgs = {"val": JDGraph(val), "test": JDGraph(test)}
    hm = JHookManager(keys=["val", "test"])
    for split in ("val", "test"):
        hm.register(split, JTGB(candidates=cands[split]))
    hm.register_shared(JRecency(N, [K], ["edge_src", "edge_dst", "neg"],
                                ["edge_time", "edge_time", "neg_time"],
                                edge_dim=EDGE_DIM, edge_x_full=data.edge_x))
    memory = JMemory(num_nodes=N, raw_msg_dim=EDGE_DIM, memory_dim=DIM, time_dim=DIM)
    encoder = JAttn(in_channels=DIM, out_channels=DIM, msg_dim=EDGE_DIM, time_dim=DIM,
                    dropout=0.0)
    decoder = JLinkPredictor(node_dim=DIM, hidden_dim=DIM)
    params = jax_params(memory, encoder, decoder)
    _, eval_core = j_build_cores(memory, encoder, decoder, None, N, style="rowwise")
    carry = (params, memory.init_state())
    sums, neg_times = [], []
    for split in ("val", "test"):
        stream = JStream(dgs[split], BSIZE)
        fn, states = hm.as_transform(split, dgs[split])

        @jax.jit
        def step(states, carry, i):
            states, batch = fn(states, stream.batch_at(i))
            carry, (s, c) = eval_core(carry, batch)
            return states, carry, s, batch.neg_time

        for i in range(stream.num_batches):
            states, carry, s, nt = step(states, carry, i)
            sums.append(float(s))
            neg_times.append(np.asarray(nt))
        hm.adopt_states(split, states)
    rec_state = [h for h in hm._key_to_hooks["val"] if isinstance(h, JRecency)][0].state
    return params, carry[1], rec_state, sums, neg_times


def run_port(src, dst, t, edge_x, cands, params, neg_times):
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    dgs = {"val": DGraph(val), "test": DGraph(test)}
    injected = iter(neg_times)
    hm = HookManager(keys=["val", "test"])
    for split in ("val", "test"):
        tgb = TGBNegativeEdgeSamplerHook(cands[split], device="cpu")
        tgb.draw_neg_time = lambda n, lo, hi: torch.from_numpy(next(injected).copy())
        hm.register(split, tgb)
    rec = RecencyNeighborHook(N, [K], ["edge_src", "edge_dst", "neg"],
                              ["edge_time", "edge_time", "neg_time"],
                              edge_dim=EDGE_DIM, edge_x_full=data.edge_x, device="cpu")
    hm.register_shared(rec)
    memory = TGNMemory(N, EDGE_DIM, DIM, DIM)
    encoder = GraphAttentionEmbeddingRowwise(DIM, DIM, EDGE_DIM, DIM, dropout=0.0)
    decoder = LinkPredictor(node_dim=DIM, hidden_dim=DIM)
    load_tgn_params(params, memory, encoder, decoder)
    for m in (memory, encoder, decoder):
        m.eval()
    _, eval_core = build_tgn_hook_cores(memory, encoder, decoder, None, N, style="rowwise")
    mem_state = memory.init_state("cpu")
    sums = []
    for split in ("val", "test"):
        stream = DeviceEdgeStream(dgs[split], BSIZE, device="cpu")
        epoch, states = hook_epoch(stream, hm, split, dgs[split], eval_core)
        mem_state, states, (s, c) = epoch(mem_state, states)
        hm.adopt_states(split, states)
        sums += s.tolist()
    return mem_state, rec.state, sums


@pytest.mark.parametrize("popularity", ["uniform", "zipf"])
def test_slice_matches_jax_eval_core(popularity):
    src, dst, t, edge_x, rng, pop = make_stream(popularity)
    val_t = 0 + int((t[-1] + 1) * 0.7)
    test_t = val_t + int((t[-1] + 1) * 0.15)
    n_val = int(((t >= val_t) & (t < test_t)).sum())
    n_test = int((t >= test_t).sum())
    cands = {"val": rng.choice(N, (n_val, Q), p=pop), "test": rng.choice(N, (n_test, Q), p=pop)}
    # Padded tail batches in both splits exercise the edge_valid paths.
    assert n_val % BSIZE and n_test % BSIZE

    params, j_mem, j_rec, j_sums, neg_times = run_jax(src, dst, t, edge_x, cands)
    mem, rec, sums = run_port(src, dst, t, edge_x, cands, params, neg_times)

    assert len(sums) == len(j_sums) >= 4
    np.testing.assert_allclose(sums, j_sums, rtol=0, atol=1e-5)
    for got, want in zip(rec, j_rec):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid"):
        np.testing.assert_array_equal(getattr(mem, name).numpy(), np.asarray(getattr(j_mem, name)),
                                      err_msg=name)
    for name in ("mem", "s_raw", "d_raw"):
        np.testing.assert_allclose(getattr(mem, name).numpy(), np.asarray(getattr(j_mem, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    # The stream did move the memory: the comparison is not of zeros.
    assert np.abs(mem.mem.numpy()).max() > 0.1


@pytest.mark.parametrize("kwargs", [{}, {"style": "segment"}])
def test_unported_cores_raise(kwargs):
    """The segment style, the JAX default, is ported (queue 1 item 6): both
    calls build the segment cores, whose train core raises without an
    optimizer, as the rowwise one does; an unknown style raises."""
    from tgm_tpu_torch.nn import GraphAttentionEmbedding

    mods = (TGNMemory(N, EDGE_DIM, DIM, DIM), GraphAttentionEmbedding(DIM, DIM, EDGE_DIM, DIM),
            LinkPredictor(node_dim=DIM, hidden_dim=DIM))
    train_core, eval_core = build_tgn_hook_cores(*mods, None, N, **kwargs)
    with pytest.raises(ValueError, match="optimizer"):
        train_core.loss_and_grad(None, None, None)
    with pytest.raises(ValueError, match="Unknown style"):
        build_tgn_hook_cores(*mods, None, N, style="dense")
