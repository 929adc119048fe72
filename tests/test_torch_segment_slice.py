"""The TGN segment slice as a whole: the example's ``--encoder segment`` flow
in both packages.

Two epochs of train, ``flush_all``, val and test on a small stream (120
nodes, 800 edges, batch 100, 5 candidates per eval edge, K = 10, memory /
time / embed dims 16 / 8 / 16, 8-dim edge features, made with numpy from a
seed), split 70/15/15, with the hook state and the memory reset between
epochs, as ``examples/linkproppred/tgn.py --encoder segment`` runs it: the
shared ``DeduplicationHook`` after the recency hook, memory staged over the
batch's unique nodes, the segment ``GraphAttentionEmbedding``, the flush
commit. Same weights (JAX's init, loaded by ``tgm_tpu_torch.weights``),
dropout 0, Adam at lr 1e-3 in both (``optax.adam`` and ``torch.optim.Adam``). The two frameworks draw
different random numbers, so the port is fed the JAX random-negative hook's
``neg`` and the JAX TGB hook's ``neg_time`` of each batch.

Bands (the North star's): per-batch losses within 5e-3 and the first within
1e-5; val MRR within 0.01 and test MRR within 0.02 per epoch; integer
recency and memory state exact after each epoch. The measured maxima are
printed.

The port's example script (``python -m tgm_tpu_torch.examples.linkproppred.tgn
--encoder segment``) runs one epoch on the CPU at its full default width;
with ``--fast`` it trains the rowwise ``TGNPipeline``, as the JAX
``run_fast`` does whatever ``--encoder`` says (checked at dims 8).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.hooks import DeduplicationHook as JDedup
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.tgn import GraphAttentionEmbedding as JAttn
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train.programs import build_tgn_hook_cores as j_build_cores
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.examples.linkproppred import tgn as tgn_example
from tgm_tpu_torch.hooks import (
    DeduplicationHook,
    HookManager,
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from tgm_tpu_torch.nn import GraphAttentionEmbedding, LinkPredictor, TGNMemory
from tgm_tpu_torch.train import DeviceEdgeStream, build_tgn_hook_cores, hook_epoch
from tgm_tpu_torch.weights import load_tgn_params

N, E, BSIZE, Q, K, MEM, TIME, EMB, EDGE_DIM = 120, 800, 100, 5, 10, 16, 8, 16, 8
EPOCHS, LR = 2, 1e-3
SPLITS = ("train", "val", "test")
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    return src, dst, t, edge_x, rng


def run_jax(src, dst, t, edge_x, cands):
    """The JAX example's segment flow; returns per-epoch records and the injections."""
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    dgs = dict(zip(SPLITS, (JDGraph(d) for d in data.split())))
    hm = JHookManager(keys=list(SPLITS))
    train_dst = dgs["train"].edge_dst
    hm.register("train", JRandomNeg(low=int(train_dst.min()), high=int(train_dst.max())))
    for split in ("val", "test"):
        hm.register(split, JTGB(candidates=cands[split]))
    rec = JRecency(N, [K], ["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"],
                   edge_dim=EDGE_DIM, edge_x_full=data.edge_x)
    hm.register_shared(rec)
    hm.register_shared(JDedup(N, seed_nodes_keys=["neg", "nbr_nids"]))
    memory = JMemory(num_nodes=N, raw_msg_dim=EDGE_DIM, memory_dim=MEM, time_dim=TIME)
    encoder = JAttn(in_channels=MEM, out_channels=EMB, msg_dim=EDGE_DIM, time_dim=TIME,
                    dropout=0.0)
    decoder = JLinkPredictor(node_dim=EMB, hidden_dim=EMB)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    params = {
        "mem": memory.init(k1, memory.init_state(), jnp.zeros(8, jnp.int32)),
        "enc": encoder.init(
            k2, jnp.zeros((8, MEM)), jnp.zeros(8, jnp.int32), jnp.zeros(4, jnp.int32),
            jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32), jnp.zeros((4, EDGE_DIM)),
            jnp.ones(4, bool),
        ),
        "dec": decoder.init(k3, jnp.zeros((1, EMB)), jnp.zeros((1, EMB))),
    }
    init_params = params
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    train_core, eval_core = j_build_cores(memory, encoder, decoder, opt, N, style="segment")
    streams = {s: JStream(dgs[s], BSIZE) for s in SPLITS}
    steps = {}

    def step_fn(split):
        if split not in steps:
            fn, _ = hm.as_transform(split, dgs[split])
            core = train_core if split == "train" else eval_core

            @jax.jit
            def step(states, carry, i):
                states, batch = fn(states, streams[split].batch_at(i))
                carry, out = core(carry, batch)
                return states, carry, out, batch.neg if split == "train" else batch.neg_time

            steps[split] = step
        return steps[split]

    flush_all = jax.jit(lambda p, s: memory.apply(p["mem"], s, method=JMemory.flush_all))
    key = jax.random.PRNGKey(0)
    epochs, injected = [], {"neg": [], "neg_time": []}
    for _ in range(EPOCHS):
        mem_state = memory.init_state()
        _, states = hm.as_transform("train", dgs["train"])
        losses = []
        carry = (params, opt_state, mem_state, key)
        for i in range(streams["train"].num_batches):
            states, carry, loss, neg = step_fn("train")(states, carry, i)
            losses.append(float(loss))
            injected["neg"].append(np.asarray(neg))
        hm.adopt_states("train", states)
        params, opt_state, mem_state, key = carry
        mem_state = flush_all(params, mem_state)
        mrr = {}
        for split in ("val", "test"):
            _, states = hm.as_transform(split, dgs[split])
            s_sum, c_sum = 0.0, 0.0
            carry = (params, mem_state)
            for i in range(streams[split].num_batches):
                states, carry, (s, c), nt = step_fn(split)(states, carry, i)
                s_sum, c_sum = s_sum + float(s), c_sum + float(c)
                injected["neg_time"].append(np.asarray(nt))
            hm.adopt_states(split, states)
            mem_state = carry[1]
            mrr[split] = s_sum / max(c_sum, 1.0)
        epochs.append(dict(losses=losses, mrr=mrr, rec=[np.asarray(x) for x in rec.state],
                           mem={n: np.asarray(getattr(mem_state, n)) for n in INT_FIELDS}))
        hm.reset_state()
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
                zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(init_params)))
    return init_params, epochs, injected, moved


def run_port(src, dst, t, edge_x, cands, params, injected):
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    dgs = dict(zip(SPLITS, (DGraph(d) for d in data.split())))
    negs, neg_times = iter(injected["neg"]), iter(injected["neg_time"])
    hm = HookManager(keys=list(SPLITS))
    train_dst = dgs["train"].edge_dst
    rnd = RandomNegativeEdgeSamplerHook(low=int(train_dst.min()), high=int(train_dst.max()),
                                        device="cpu")
    rnd.draw_neg = lambda size: torch.from_numpy(next(negs).copy())
    hm.register("train", rnd)
    for split in ("val", "test"):
        tgb = TGBNegativeEdgeSamplerHook(cands[split], device="cpu")
        tgb.draw_neg_time = lambda n, lo, hi: torch.from_numpy(next(neg_times).copy())
        hm.register(split, tgb)
    rec = RecencyNeighborHook(N, [K], ["edge_src", "edge_dst", "neg"],
                              ["edge_time", "edge_time", "neg_time"],
                              edge_dim=EDGE_DIM, edge_x_full=data.edge_x, device="cpu")
    hm.register_shared(rec)
    hm.register_shared(DeduplicationHook(N, seed_nodes_keys=["neg", "nbr_nids"]))
    memory = TGNMemory(N, EDGE_DIM, MEM, TIME)
    encoder = GraphAttentionEmbedding(MEM, EMB, EDGE_DIM, TIME, dropout=0.0)
    decoder = LinkPredictor(node_dim=EMB, hidden_dim=EMB)
    load_tgn_params(params, memory, encoder, decoder)
    opt = torch.optim.Adam([p for m in (memory, encoder, decoder) for p in m.parameters()],
                           lr=LR)
    train_core, eval_core = build_tgn_hook_cores(memory, encoder, decoder, opt, N,
                                                 style="segment")
    streams = {s: DeviceEdgeStream(dgs[s], BSIZE, device="cpu") for s in SPLITS}
    epochs = []
    for _ in range(EPOCHS):
        mem_state = memory.init_state("cpu")
        epoch, states = hook_epoch(streams["train"], hm, "train", dgs["train"], train_core)
        (mem_state, _), states, losses = epoch((mem_state, None), states)
        hm.adopt_states("train", states)
        mem_state = memory.flush_all(mem_state)
        mrr = {}
        for split in ("val", "test"):
            epoch, states = hook_epoch(streams[split], hm, split, dgs[split], eval_core)
            mem_state, states, (s, c) = epoch(mem_state, states)
            hm.adopt_states(split, states)
            mrr[split] = float(s.sum() / c.sum().clamp_min(1.0))
        epochs.append(dict(losses=losses.tolist(), mrr=mrr,
                           rec=[x.numpy().copy() for x in rec.state],
                           mem={n: getattr(mem_state, n).numpy().copy() for n in INT_FIELDS}))
        hm.reset_state()
    assert next(negs, None) is None and next(neg_times, None) is None
    return epochs


def test_two_segment_epochs_match_the_jax_example_flow():
    src, dst, t, edge_x, rng = make_stream(0)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    cands = {"val": rng.integers(0, N, (val.num_edge_events, Q)),
             "test": rng.integers(0, N, (test.num_edge_events, Q))}
    params, j_epochs, injected, j_moved = run_jax(src, dst, t, edge_x, cands)
    p_epochs = run_port(src, dst, t, edge_x, cands, params, injected)

    loss_diff = [np.abs(np.subtract(p["losses"], j["losses"])) for p, j in zip(p_epochs, j_epochs)]
    mrr_diff = {s: max(abs(p["mrr"][s] - j["mrr"][s]) for p, j in zip(p_epochs, j_epochs))
                for s in ("val", "test")}
    losses = np.concatenate([j["losses"] for j in j_epochs])
    print(f"train steps {losses.size}: first-loss diff {loss_diff[0][0]:.3g}, max loss diff "
          f"{max(d.max() for d in loss_diff):.3g}; max val MRR diff {mrr_diff['val']:.3g}, max "
          f"test MRR diff {mrr_diff['test']:.3g}; JAX losses {np.round(losses, 5).tolist()}, "
          f"MRR {[j['mrr'] for j in j_epochs]}; largest JAX weight move {j_moved:.3g}")
    assert losses.size == 12
    assert loss_diff[0][0] <= 1e-5
    assert max(d.max() for d in loss_diff) <= 5e-3
    assert mrr_diff["val"] <= 0.01 and mrr_diff["test"] <= 0.02
    for e, (p, j) in enumerate(zip(p_epochs, j_epochs)):
        for name, a, b in zip(("nbr_ids", "nbr_times", "nbr_eids", "write_pos"), p["rec"], j["rec"]):
            np.testing.assert_array_equal(a, b, err_msg=f"epoch {e} recency {name}")
        for name in INT_FIELDS:
            np.testing.assert_array_equal(p["mem"][name], j["mem"][name],
                                          err_msg=f"epoch {e} memory {name}")
        assert all(0.0 < p["mrr"][s] <= 1.0 for s in ("val", "test"))
    # The run learned something: the loss moved and the weights moved.
    assert losses.max() - losses.min() > 1e-3
    assert j_moved > 1e-3


def test_example_script_segment_route_runs_one_epoch_on_the_cpu(tmp_path):
    log = tmp_path / "metrics.jsonl"
    out = tgn_example.main(["--dataset", "synthetic-120-800", "--epochs", "1", "--device", "cpu",
                            "--encoder", "segment", "--log-file-path", str(log)])
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert 0.0 < out["val_mrr"] <= 1.0 and 0.0 < out["test_mrr"] <= 1.0
    metrics = [json.loads(line) for line in log.read_text().splitlines()]
    assert [m["metric"] for m in metrics] == ["loss", "val_mrr", "test_mrr"]


def test_example_script_fast_route_is_rowwise_whatever_the_encoder(capsys):
    narrow = ["--memory-dim", "8", "--time-dim", "8", "--embed-dim", "8"]
    outs = [tgn_example.main(["--dataset", "synthetic-120-800", "--fast", "--device", "cpu",
                              *narrow, *flags]) for flags in ([], ["--encoder", "segment"])]
    assert outs[0]["loss"] == outs[1]["loss"]  # the same rowwise pipeline, the same seed
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("epoch=")]
    assert len(lines) == 2
