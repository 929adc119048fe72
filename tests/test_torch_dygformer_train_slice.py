"""The DyGFormer train slice as a whole: the example's flow in both packages.

Two epochs of train then val, the hook state reset after each, then train
and val replayed through the hooks alone and test evaluated, as
``examples/linkproppred/dygformer.py`` runs it, on a small stream (120
nodes, 800 edges, batch 100, 5 candidates per eval edge, K = 10 recency
neighbours in the feature-buffer layout, edge / time / channel dims 8 / 8 /
8, 2 layers, 2 heads, sequences of 16, output 16, made with numpy from a
seed), split 70/15/15. Same weights (JAX's init, loaded by
``load_dygformer_params``), dropout 0, Adam at lr 1e-3 in both, the eval
stack through the layers (the JAX example passes no ``pallas_layers``). The
two frameworks draw different random numbers, so the port is fed the JAX
random-negative hook's ``neg`` and the JAX TGB hook's ``neg_time`` of
every batch, replays included.

Bands (the North star's): per-batch losses within 5e-3 and the first within
1e-5; val MRR within 0.01 per epoch and test MRR within 0.02; recency state
(the fp32 feature buffer included) exact after each epoch. Then the first
test batch through the port's K5 route (``build_dygformer_eval_core``,
``stack="kernel"``: the plain version here) against JAX's eval with
``dygformer_pallas_layers`` (interpret mode), both with the JAX run's
trained tree (the stack rounds its weights to bf16, which would turn the
two runs' 1e-6 weight differences into bf16 ulps), within
``test_torch_dygformer_slice.py``'s bounds: scores
within 1e-2 * max |JAX score|, MRR sums within 1e-4 plus 0.5 for each
candidate the two order differently against its positive, which must be a
near tie on both sides. The measured maxima are printed.

The same flow with ``compute_bf16=True`` in both packages (the examples'
``--compute-bf16 on``), one transformer layer, without the K5 batch, the
JAX steps compiled with XLA's excess precision off so that they round
where flax's source says, as the port does (``nn/modules/bf16.py``; by
default XLA keeps some fused bf16 results in fp32). The forwards agree
(the first loss is printed), but the two backward passes flip bf16
roundings differently, and Adam's first steps, which move every weight by
about the learning rate whatever its gradient's size, turn those
differences into weights that differ by about the learning rate (ROADMAP
fault 28). So the port is held
to the JAX trajectory step by step: each train step starts from the JAX
run's weights of that step, and its loss is within 5e-3 of JAX's; val and
test run on the JAX run's weights, within 0.01 and 0.02 of JAX's MRR;
recency state exact after each epoch. The weights one port step leaves,
against JAX's next weights from the same start, are printed and bounded by
2.5 x the learning rate (fault 28's drift: Adam's first steps move weights
by about the learning rate, so a gradient component whose sign the bf16
roundings decide moves them that far apart).

The port's example script runs one epoch on the CPU (narrow widths), with
and without ``--compute-bf16 on``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.eval.metrics import mrr_sum_count
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import RecencyNeighborHook as JRecency
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks import candidate_rows, seed_lookup
from tgm_tpu.nn import DyGFormer as JDyGFormer
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.nn.encoder.dygformer import dygformer_pallas_layers
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.examples.linkproppred import dygformer as dyg_example
from tgm_tpu_torch.hooks import (
    HookManager,
    RandomNegativeEdgeSamplerHook,
    RecencyNeighborHook,
    TGBNegativeEdgeSamplerHook,
)
from tgm_tpu_torch.nn import DyGFormer, LinkPredictor
from tgm_tpu_torch.train import (
    DeviceEdgeStream,
    build_dygformer_eval_core,
    build_dygformer_train_core,
    hook_epoch,
)
from tgm_tpu_torch.weights import load_dygformer_params

N, E, BSIZE, Q, K, EDGE_DIM, OUT = 120, 800, 100, 5, 10, 8, 16
DYG = dict(node_feat_dim=1, edge_x_dim=EDGE_DIM, time_feat_dim=8, channel_embedding_dim=8,
           output_dim=OUT, patch_size=1, num_layers=2, num_heads=2,
           max_input_sequence_length=16)
EPOCHS, LR = 2, 1e-3
SPLITS = ("train", "val", "test")
REC_NAMES = ("nbr_ids", "nbr_times", "nbr_feats", "write_pos")


def make_stream(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 2 * E, E))
    edge_x = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    node_x = rng.normal(size=(N, 1)).astype(np.float32)
    return src, dst, t, edge_x, node_x, rng


def source_rounding(jitted):
    """``jitted``, compiled at its first call with XLA's excess precision
    off, so each bf16 op rounds its result where the JAX source says, as JAX
    run op by op does (by default XLA keeps some fused bf16 results in fp32)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)

    return call


def jax_cores(encoder, decoder, opt, node_x):
    """The JAX example's ``train_core`` and ``eval_core`` (no dropout), the
    eval core returning its scores too; ``pl`` is ``pallas_layers``."""

    def train_core(carry, batch):
        params, opt_state = carry
        B = batch.edge_src.shape[0]
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]
        cat = lambda a, lo: jnp.concatenate([a[:B], a[lo:lo + B]])

        def loss_fn(p):
            zs, zd = encoder.apply(p["enc"], node_x, batch.edge_src, batch.edge_dst,
                                   batch.edge_time, cat(nbr, B), cat(nt, B), cat(nx, B))
            zs2, zn = encoder.apply(p["enc"], node_x, batch.edge_src, batch.neg, batch.edge_time,
                                    cat(nbr, 2 * B), cat(nt, 2 * B), cat(nx, 2 * B))
            pos = decoder.apply(p["dec"], zs, zd)
            neg = decoder.apply(p["dec"], zs2, zn)
            m = batch.edge_valid.astype(pos.dtype)
            d = jnp.maximum(m.sum(), 1.0)
            return (jnp.sum(optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos)) * m)
                    + jnp.sum(optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)) * m)
                    ) / d

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state), loss

    def eval_core(params, batch, pl=None):
        B = batch.edge_src.shape[0]
        Qb = batch.neg_batch_list.shape[1]
        nbr, nt, nx = batch.nbr_nids[0], batch.nbr_edge_time[0], batch.nbr_edge_x[0]
        cat = lambda a: jnp.concatenate([a[:B], a[B:2 * B]])
        zs, zd = encoder.apply(params["enc"], node_x, batch.edge_src, batch.edge_dst,
                               batch.edge_time, cat(nbr), cat(nt), cat(nx), pallas_layers=pl)
        pos = decoder.apply(params["dec"], zs, zd)
        negs = batch.neg_batch_list.reshape(-1)
        rows, found = candidate_rows(seed_lookup(batch.seed_nids[0], N), negs, nbr.shape[0])
        rep = lambda a: jnp.concatenate([jnp.repeat(a[:B], Qb, axis=0), a[rows]])
        zs2, zn = encoder.apply(params["enc"], node_x, jnp.repeat(batch.edge_src, Qb), negs,
                                jnp.repeat(batch.edge_time, Qb), rep(nbr), rep(nt), rep(nx),
                                pallas_layers=pl)
        neg = decoder.apply(params["dec"], zs2, zn).reshape(B, Qb)
        neg_valid = (batch.neg_batch_list != PADDED_NODE_ID) & found.reshape(B, Qb)
        s, c = mrr_sum_count(pos, neg, neg_valid=neg_valid, edge_valid=batch.edge_valid)
        return s, c, pos, neg, neg_valid & batch.edge_valid[:, None]

    return train_core, eval_core


def run_jax(src, dst, t, edge_x, node_x, cands, compute_bf16=False):
    """The JAX example's flow; returns the initial and the trained params,
    per-epoch records, the injections, the test MRR, the first test batch's
    Pallas scores and the largest weight move."""
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    dgs = dict(zip(SPLITS, (JDGraph(d) for d in data.split())))
    hm = JHookManager(keys=list(SPLITS))
    train_dst = dgs["train"].edge_dst
    hm.register("train", JRandomNeg(low=int(train_dst.min()), high=int(train_dst.max())))
    for split in ("val", "test"):
        hm.register(split, JTGB(candidates=cands[split]))
    rec = JRecency(N, [K], ["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"],
                   edge_dim=EDGE_DIM)
    hm.register_shared(rec)
    # One layer in bf16: the jitted bf16 step compiles slowly, and the layers
    # repeat one computation.
    layers = 1 if compute_bf16 else DYG["num_layers"]
    encoder = JDyGFormer(dropout=0.0, compute_bf16=compute_bf16, **dict(DYG, num_layers=layers))
    decoder = JLinkPredictor(node_dim=OUT, hidden_dim=OUT)
    z = lambda *s: jnp.zeros(s, jnp.int32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    init = jax.jit(encoder.init) if compute_bf16 else encoder.init
    params = {"enc": init(k1, jnp.asarray(node_x), z(4), z(4), z(4), z(8, K), z(8, K),
                                  jnp.zeros((8, K, EDGE_DIM))),
              "dec": decoder.init(k2, jnp.zeros((1, OUT)), jnp.zeros((1, OUT)))}
    init_params = params
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    train_core, eval_core = jax_cores(encoder, decoder, opt, jnp.asarray(node_x))
    streams = {s: JStream(dgs[s], BSIZE) for s in SPLITS}
    fns = {s: hm.as_transform(s, dgs[s])[0] for s in SPLITS}
    draw = lambda b, split: b.neg if split == "train" else b.neg_time

    @jax.jit
    def train_step(states, carry, i):
        states, batch = fns["train"](states, streams["train"].batch_at(i))
        carry, loss = train_core(carry, batch)
        return states, carry, loss, batch.neg

    def eval_step(split, with_pallas):
        @jax.jit
        def step(states, params, i):
            states, batch = fns[split](states, streams[split].batch_at(i))
            out = eval_core(params, batch)
            pl = dygformer_pallas_layers(params["enc"], 2) if with_pallas else None
            return states, out, batch.neg_time, eval_core(params, batch, pl) if pl else None

        return step

    if compute_bf16:
        train_step = source_rounding(train_step)
    replay_steps = {s: jax.jit(lambda st, i, s=s: (lambda r: (r[0], draw(r[1], s)))(
        fns[s](st, streams[s].batch_at(i)))) for s in ("train", "val")}
    injected = {"neg": [], "neg_time": []}
    step_params = []  # the weights each train step starts from
    steps = {(s, w): eval_step(s, w) for s in ("val", "test") for w in (False, True)}
    if compute_bf16:
        steps = {k: source_rounding(v) for k, v in steps.items()}

    def run_eval(split, n_pallas=0):
        _, states = hm.as_transform(split, dgs[split])
        s_sum, c_sum, pallas = 0.0, 0.0, []
        for i in range(streams[split].num_batches):
            states, (s, c, *_), nt, pl_out = steps[split, i < n_pallas](states, params, i)
            s_sum, c_sum = s_sum + float(s), c_sum + float(c)
            injected["neg_time"].append(np.asarray(nt))
            if pl_out is not None:
                pallas.append([np.asarray(x) for x in pl_out])
        hm.adopt_states(split, states)
        return s_sum / max(c_sum, 1.0), pallas

    epochs = []
    for _ in range(EPOCHS):
        _, states = hm.as_transform("train", dgs["train"])
        losses, carry = [], (params, opt_state)
        for i in range(streams["train"].num_batches):
            step_params.append(carry[0])
            states, carry, loss, neg = train_step(states, carry, i)
            losses.append(float(loss))
            injected["neg"].append(np.asarray(neg))
        hm.adopt_states("train", states)
        params, opt_state = carry
        val_mrr, _ = run_eval("val")
        epochs.append(dict(losses=losses, val_mrr=val_mrr, params=params,
                           rec=[np.asarray(x).copy() for x in rec.state]))
        hm.reset_state()
    for split in ("train", "val"):
        _, states = hm.as_transform(split, dgs[split])
        for i in range(streams[split].num_batches):
            states, d = replay_steps[split](states, i)
            injected["neg" if split == "train" else "neg_time"].append(np.asarray(d))
        hm.adopt_states(split, states)
    test_mrr, pallas = run_eval("test", n_pallas=0 if compute_bf16 else 1)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
                zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(init_params)))
    injected["step_params"] = step_params
    return init_params, params, epochs, injected, test_mrr, pallas, moved


def run_port(src, dst, t, edge_x, node_x, cands, params, injected, trained,
             compute_bf16=False, eval_weights=None, step_weights=None):
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
                              ["edge_time", "edge_time", "neg_time"], edge_dim=EDGE_DIM,
                              device="cpu")
    hm.register_shared(rec)
    dyg = dict(DYG, num_layers=1) if compute_bf16 else DYG
    encoder = DyGFormer(dropout=0.0, compute_bf16=compute_bf16, **dyg)
    decoder = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
    load_dygformer_params(params, encoder, decoder)
    x = torch.from_numpy(node_x)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=LR)
    train_core = build_dygformer_train_core(encoder, decoder, opt, x)
    step_drift = []
    if step_weights is not None:
        # Each step starts from the given weights: its loss is a forward on
        # them, and the weights it leaves are held against the next ones.
        inner, forced = train_core, iter(step_weights)
        mods = (encoder, decoder)

        def train_core(carry, batch):
            own = [p.detach().clone() for m in mods for p in m.parameters()]
            load_dygformer_params(next(forced), encoder, decoder)
            if own:
                step_drift.append(max(float((a - p).abs().max()) for a, p in
                                      zip(own, (p for m in mods for p in m.parameters()))))
            return inner(carry, batch)
    streams = {s: DeviceEdgeStream(dgs[s], BSIZE, device="cpu") for s in SPLITS}

    def run_eval(split, n_kernel=0, weights=None):
        core = build_dygformer_eval_core(encoder, decoder, x, N, stack="module")
        if weights is not None:
            w_enc = DyGFormer(dropout=0.0, compute_bf16=compute_bf16, **dyg)
            w_dec = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
            load_dygformer_params(weights, w_enc, w_dec)
            core = build_dygformer_eval_core(w_enc, w_dec, x, N, stack="module")
        if n_kernel:
            k5_enc = DyGFormer(dropout=0.0, **DYG)
            k5_dec = LinkPredictor(node_dim=OUT, hidden_dim=OUT)
            load_dygformer_params(trained, k5_enc, k5_dec)
            k5 = build_dygformer_eval_core(k5_enc, k5_dec, x, N, stack="kernel")
        kernel_out = []

        def step(carry, batch):
            if len(kernel_out) < n_kernel:
                B = batch.edge_src.shape[0]
                z = k5.embed(batch)
                with torch.no_grad():
                    sc = k5_dec(*z)
                kernel_out.append((float(k5.score(batch, *z)[0]), sc[:B].numpy(),
                                   sc[B:].reshape(B, -1).numpy()))
            return core(carry, batch)

        epoch, states = hook_epoch(streams[split], hm, split, dgs[split], step)
        _, states, (s, c) = epoch(None, states)
        hm.adopt_states(split, states)
        return float(s.sum() / c.sum().clamp_min(1.0)), kernel_out

    def replay(split):
        epoch, states = hook_epoch(streams[split], hm, split, dgs[split],
                                   lambda carry, batch: (carry, torch.zeros(())))
        _, states, _ = epoch(None, states)
        hm.adopt_states(split, states)

    # ``eval_weights``: the trees each eval (val after each epoch, then test) runs on.
    weights = iter(eval_weights or [None] * (EPOCHS + 1))
    epochs = []
    for _ in range(EPOCHS):
        epoch, states = hook_epoch(streams["train"], hm, "train", dgs["train"], train_core)
        (_,), states, losses = epoch((None,), states)
        hm.adopt_states("train", states)
        val_mrr, _ = run_eval("val", weights=next(weights))
        epochs.append(dict(losses=losses.tolist(), val_mrr=val_mrr,
                           rec=[x.numpy().copy() for x in rec.state]))
        hm.reset_state()
    replay("train")
    replay("val")
    test_mrr, kernel_out = run_eval("test", n_kernel=0 if compute_bf16 else 1,
                                    weights=next(weights))
    assert next(negs, None) is None and next(neg_times, None) is None
    if step_weights is not None:
        epochs[0]["step_drift"] = step_drift[1:]  # the first entry is the initial load
    return epochs, test_mrr, kernel_out


def test_two_epochs_match_the_jax_example_flow():
    src, dst, t, edge_x, node_x, rng = make_stream(0)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    cands = {"val": rng.integers(0, N, (val.num_edge_events, Q)),
             "test": rng.integers(0, N, (test.num_edge_events, Q))}
    params, trained, j_epochs, injected, j_test, j_pallas, j_moved = run_jax(
        src, dst, t, edge_x, node_x, cands)
    p_epochs, p_test, p_kernel = run_port(src, dst, t, edge_x, node_x, cands, params, injected,
                                          trained)

    loss_diff = np.abs(np.subtract([p["losses"] for p in p_epochs],
                                   [j["losses"] for j in j_epochs]))
    val_diff = max(abs(p["val_mrr"] - j["val_mrr"]) for p, j in zip(p_epochs, j_epochs))
    losses = np.concatenate([j["losses"] for j in j_epochs])
    print(f"train steps {losses.size}: first-loss diff {loss_diff.flat[0]:.3g}, max loss diff "
          f"{loss_diff.max():.3g}; max val MRR diff {val_diff:.3g}, test MRR diff "
          f"{abs(p_test - j_test):.3g}; JAX losses {np.round(losses, 5).tolist()}, val MRR "
          f"{[j['val_mrr'] for j in j_epochs]}, test MRR {j_test}; largest JAX weight move "
          f"{j_moved:.3g}")
    assert losses.size == 12
    assert loss_diff.flat[0] <= 1e-5 and loss_diff.max() <= 5e-3
    assert val_diff <= 0.01 and abs(p_test - j_test) <= 0.02
    for e, (p, j) in enumerate(zip(p_epochs, j_epochs)):
        for name, a, b in zip(REC_NAMES, p["rec"], j["rec"]):
            np.testing.assert_array_equal(a, b, err_msg=f"epoch {e} recency {name}")
        assert 0.0 < p["val_mrr"] <= 1.0
    assert np.abs(p_epochs[-1]["rec"][2]).max() > 0.5  # the rings carry features
    assert losses.max() - losses.min() > 1e-3 and j_moved > 1e-3  # the run learned

    # The first test batch through the port's K5 route against JAX's Pallas stack.
    (got_sum, pos, neg), ((j_sum, _, j_pos, j_neg, valid),) = p_kernel[0], j_pallas
    tol = 1e-2 * max(np.abs(j_pos).max(), np.abs(j_neg).max())
    assert np.abs(pos - j_pos).max() <= tol and np.abs(neg - j_neg).max() <= tol
    order = lambda p, n: np.sign(n - p[:, None])
    flipped = (order(pos, neg) != order(j_pos, j_neg)) & valid
    assert (np.abs(neg - pos[:, None])[flipped] <= tol).all()
    assert (np.abs(j_neg - j_pos[:, None])[flipped] <= tol).all()
    assert abs(got_sum - float(j_sum)) <= 1e-4 + 0.5 * flipped.sum() and flipped.sum() <= 2
    diff = max(np.abs(pos - j_pos).max(), np.abs(neg - j_neg).max())
    print(f"K5 route, first test batch: max score diff {diff:.3g} (tol {tol:.3g}), MRR sums "
          f"{got_sum} and {float(j_sum)}, {int(flipped.sum())} order flips")


@pytest.mark.parametrize("flags", [[], ["--dyg-pairs", "fused", "--dyg-stack", "kernel"],
                                   ["--compute-bf16", "on", "--dyg-stack", "kernel"]])
def test_example_script_runs_one_epoch_on_the_cpu(flags, capsys):
    out = dyg_example.main(["--dataset", "synthetic-120-800", "--epochs", "1", "--device", "cpu",
                            "--channel-dim", "8", "--time-dim", "8", "--embed-dim", "16",
                            "--max-seq-len", "8", "--n-nbrs", "5", *flags])
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert 0.0 < out["val_mrr"] <= 1.0 and 0.0 < out["test_mrr"] <= 1.0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("epoch=0 loss=") and lines[-1].startswith("test_mrr=")


def test_compute_bf16_matches_the_jax_example_flow():
    src, dst, t, edge_x, node_x, rng = make_stream(0)
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    _, val, test = data.split()
    cands = {"val": rng.integers(0, N, (val.num_edge_events, Q)),
             "test": rng.integers(0, N, (test.num_edge_events, Q))}
    params, trained, j_epochs, injected, j_test, _, _ = run_jax(src, dst, t, edge_x, node_x,
                                                                cands, compute_bf16=True)
    run = lambda weights, step_weights=None: run_port(
        src, dst, t, edge_x, node_x, cands, params, injected, trained, compute_bf16=True,
        eval_weights=weights, step_weights=step_weights)
    j_losses = [j["losses"] for j in j_epochs]
    p_epochs, p_test, _ = run([e["params"] for e in j_epochs] + [trained],
                              step_weights=injected["step_params"])
    loss_diff = np.abs(np.subtract([p["losses"] for p in p_epochs], j_losses))
    val_diff = max(abs(p["val_mrr"] - j["val_mrr"]) for p, j in zip(p_epochs, j_epochs))
    drift = p_epochs[0]["step_drift"]
    print(f"compute_bf16 on JAX's weights: first-loss diff {loss_diff.flat[0]:.3g}, max loss "
          f"diff {loss_diff.max():.3g}, max val MRR diff {val_diff:.3g}, test MRR diff "
          f"{abs(p_test - j_test):.3g}; one step from JAX's weights leaves weights up to "
          f"{max(drift):.3g} from JAX's next ones (lr {LR})")
    assert loss_diff.max() <= 5e-3
    assert val_diff <= 0.01 and abs(p_test - j_test) <= 0.02
    assert len(drift) == len(injected["step_params"]) - 1 and max(drift) <= 2.5 * LR
    for e, (p, j) in enumerate(zip(p_epochs, j_epochs)):
        for name, a, b in zip(REC_NAMES, p["rec"], j["rec"]):
            np.testing.assert_array_equal(a, b, err_msg=f"epoch {e} recency {name}")
