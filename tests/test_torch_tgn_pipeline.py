"""``TGNPipeline`` of the port against the JAX ``TGNPipeline`` and the hook path.

A small stream made with numpy from a seed: 40 nodes, 330 train edges
(batch 64, so the last batch is partial) and 180 val edges after them
(3 batches, the last partial), 6-dim edge features, memory and embed dims
8, time dim 6, K = 5, Adam at lr 1e-3, eid recency layout over the
pre-split feature table. Once with uniform node popularity, once with the
bench recipe's ``zipf(1.4)``, where most candidate scores tie exactly (the
port scores positives and candidates in one decoder call, the JAX pipeline
in two). Same weights (the JAX ``init_carry``'s, loaded by
``init_carry(params=...)``); the two frameworks draw different random
numbers, so the port is fed the negatives the JAX ``train_step`` draws (its
``carry.rng`` split as ``tgm_tpu/train/tgn_pipeline.py:344-349`` does).

Tolerances (fp32, different summation orders): two train epochs' losses
within 1e-5 (each epoch from fresh memory and recency state, as the
example's epochs run), recency state and integer memory fields exact,
memory and ``forward_only`` scores within 1e-4 (Adam's normalised steps
carry the last-bit gradient differences into the weights and the memory's
recurrence carries them on: measured up to 4.0e-5 for the memory and
2.1e-5 for the scores after 12 steps, with every loss within 6e-7); after ``flush_all``, 3 val batches through ``eval_step`` with 5
candidates per edge (some PAD), with and without the pre-projected feature
table: MRR counts equal, sums within 1e-5. Within the port: the eid layout
against the feature layout (losses within 1e-6), the pipeline against the
hook ``train_core`` (losses within 1e-6, state exact), ``eval_advance_state``
against ``eval_step`` (exact), dropout drawn by no step.

The bf16 options against the JAX pipeline built with the same options, on
the uniform stream: ``attn_bf16=True`` (the bf16 K/V path and the bf16
table; eval with the bf16 pre-projected table and the bf16 memory mirror)
and ``feat_bf16=True`` with ``dedup_staging=True``; two train epochs, then
val (the first two eval batches) and test (the third), as the stream runs
on. Bands (the training parity's): losses within 5e-3, val MRR within
0.01, test MRR within 0.02, MRR counts equal; recency state, integer memory
fields and the raw message stores exact. The JAX steps are compiled with
XLA's excess precision off, so they round where the source says, as the
port does (``nn/modules/bf16.py``); the two backward passes still flip
bf16 roundings differently, so the gaps are wider than fp32's (ROADMAP
fault 28); they are printed. Within the port, bit for bit: the mirror's eval and the
eval without it (scores and state), the mirror against the bf16 cast of the
memory after every batch, the bf16 table against an fp32 table on the bf16
K/V path (``bf16(gather(x)) == gather(bf16(x))``), and ``dedup_staging``'s
staged rows (``forward_only`` scores and the first loss) against staging
every row.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.data.split import TGBSplit as JTGBSplit
from tgm_tpu.hooks.neighbors import recency_eid_init as j_recency_eid_init
from tgm_tpu.nn.encoder.tgn import tgn_init_state as j_tgn_init_state
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train import TGNPipeline as JPipeline
from tgm_tpu.train import jit_scan_epoch as j_jit_scan_epoch
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.data.split import TGBSplit
from tgm_tpu_torch.hooks import HookManager, RandomNegativeEdgeSamplerHook, RecencyNeighborHook
from tgm_tpu_torch.hooks.neighbors import recency_eid_init
from tgm_tpu_torch.nn import TGNMemoryState, tgn_init_state
from tgm_tpu_torch.train import (
    DeviceEdgeStream,
    TGNPipeline,
    build_tgn_hook_cores,
    hook_epoch,
    jit_scan_epoch,
)

N, E_TRAIN, E_VAL, D, B, MEM, EMB, TIME, K, Q = 40, 330, 180, 6, 64, 8, 8, 6, 5, 5
LR, EPOCHS = 1e-3, 2
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")
FLOAT_FIELDS = ("mem", "s_raw", "d_raw")
REC_NAMES = ("nbr_ids", "nbr_times", "nbr_eids", "write_pos")


def make_stream(popularity, seed=0):
    """(src, dst, t, edge_x, split bounds, per-val-batch candidates)."""
    rng = np.random.default_rng(seed)
    pop = None
    if popularity == "zipf":
        pop = rng.zipf(1.4, size=N).astype(np.float64)
        pop /= pop.sum()
    E = E_TRAIN + E_VAL
    src = rng.choice(N, E, p=pop)
    dst = rng.choice(N, E, p=pop)
    dst = np.where(dst == src, (dst + 1) % N, dst)
    t = np.sort(rng.integers(0, 3000, E))  # repeated times: ties inside batches
    t[E_TRAIN:] += 1  # the val split starts strictly after the train split
    edge_x = rng.normal(size=(E, D)).astype(np.float32)
    bounds = {"train": (0, int(t[E_TRAIN - 1])), "val": (int(t[E_TRAIN]), int(t[-1])),
              "test": (int(t[-1]), int(t[-1]))}
    cands = rng.choice(N, (3, B, Q), p=pop).astype(np.int32)
    cands[rng.random(cands.shape) < 0.1] = -1
    return src, dst, t, edge_x, bounds, cands


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


def run_jax(src, dst, t, edge_x, bounds, cands, opts=()):
    data = JDGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    train, val, _ = data.split(JTGBSplit(bounds))
    ts, vs = JStream(JDGraph(train), B), JStream(JDGraph(val), B)
    assert ts.num_edges == E_TRAIN and vs.num_edges == E_VAL
    pipe = JPipeline(num_nodes=N, edge_dim=D, memory_dim=MEM, embed_dim=EMB, time_dim=TIME,
                     num_nbrs=K, lr=LR, neg_low=0, neg_high=N,
                     edge_x_full=jnp.asarray(data.edge_x), **dict(opts))
    carry = pipe.init_carry(jax.random.PRNGKey(7))
    params = carry.params
    # The negatives train_step draws: split the carry's key, randint (:344-349).
    negs, key = [], carry.rng
    for _ in range(EPOCHS * ts.num_batches):
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (B,), pipe.neg_low, pipe.neg_high,
                                                  dtype=jnp.int32)))
    epoch = j_jit_scan_epoch(pipe.train_step, ts.batch_at, ts.num_batches, donate_carry=False)
    if opts:
        epoch = source_rounding(epoch)
    losses = []
    for _ in range(EPOCHS):
        # Each epoch starts from fresh memory and recency state, as the
        # example's epochs do: the stream stays chronological.
        carry = carry._replace(mem_state=j_tgn_init_state(N, MEM, D),
                               rec_state=j_recency_eid_init(N, K))
        carry, ls = epoch(carry)
        losses.append(np.asarray(ls))
    carry = jax.jit(pipe.flush_all)(carry)
    out = dict(params=params, negs=negs, losses=np.concatenate(losses), train=snapshot(carry),
               forward=np.asarray(jax.jit(lambda c: pipe.forward_only(c, vs.batch_at(0)))(carry)))
    for proj in (False, True):
        tbl = pipe.eval_proj_table(carry.params) if proj else None
        # With attn_bf16 the projected route also gathers from the bf16 mirror.
        mirror = pipe.eval_mem_bf16(carry) if proj and pipe.attn_bf16 else None
        step = jax.jit(lambda c, i, cd, m: pipe.eval_step(c, vs.batch_at(i), cd,
                                                          nbr_proj_table=tbl, mem_bf16=m))
        if opts:
            step = source_rounding(step)
        c, sums, counts = carry, [], []
        for i in range(vs.num_batches):
            out_i = step(c, i, jnp.asarray(cands[i]), mirror)
            c, (s, n) = out_i[:2]
            mirror = out_i[2] if mirror is not None else None
            sums.append(float(s))
            counts.append(float(n))
        out[proj] = (sums, counts, snapshot(c))
    return out


def snapshot(carry):
    """numpy copies of the recency buffers and memory fields of a carry (either package)."""
    mem = carry.mem_state
    return dict(rec=[np.array(x) for x in carry.rec_state],
                mem={n: np.array(getattr(mem, n)) for n in INT_FIELDS + FLOAT_FIELDS})


def clone_state(carry):
    """The carry with copies of its state tensors (the steps update them in place)."""
    return carry._replace(mem_state=TGNMemoryState(*(x.clone() for x in carry.mem_state)),
                          rec_state=tuple(x.clone() for x in carry.rec_state))


def port_streams(src, dst, t, edge_x, bounds):
    data = DGData.from_raw(t, np.stack([src, dst], 1), edge_x)
    train, val, _ = data.split(TGBSplit(bounds))
    return data, DGraph(train), DeviceEdgeStream(DGraph(train), B, device="cpu"), \
        DeviceEdgeStream(DGraph(val), B, device="cpu")


def make_pipe(edge_x_full, negs, dropout=0.0, **opts):
    pipe = TGNPipeline(N, D, MEM, EMB, TIME, K, LR, 0, N, dropout=dropout,
                       edge_x_full=edge_x_full, device="cpu", **opts)
    injected = iter(negs)
    pipe.draw_neg = lambda rng, size: torch.from_numpy(next(injected).copy())
    return pipe


def run_port(src, dst, t, edge_x, bounds, cands, params, negs, opts=()):
    data, _, ts, vs = port_streams(src, dst, t, edge_x, bounds)
    pipe = make_pipe(data.edge_x, negs, **dict(opts))
    carry = pipe.init_carry(0, params=params)
    epoch = jit_scan_epoch(pipe.train_step, ts.batch_at, ts.num_batches)
    losses = []
    for _ in range(EPOCHS):
        carry = carry._replace(mem_state=tgn_init_state(N, MEM, D, "cpu"),
                               rec_state=recency_eid_init(N, K, "cpu"))
        carry, ls = epoch(carry)
        losses.append(ls.numpy())
    carry = pipe.flush_all(carry)
    before = snapshot(carry)
    out = dict(losses=np.concatenate(losses), train=before,
               forward=pipe.forward_only(carry, vs.batch_at(0)).numpy())
    after = snapshot(carry)
    assert all(np.array_equal(a, b) for a, b in zip(before["rec"], after["rec"]))
    assert all(np.array_equal(before["mem"][n], after["mem"][n]) for n in before["mem"])
    for proj in (False, True):
        c = clone_state(carry)
        tbl = pipe.eval_proj_table(c.params) if proj else None
        mirror = pipe.eval_mem_bf16(c) if proj and pipe.attn_bf16 else None
        sums, counts = [], []
        for i in range(vs.num_batches):
            out_i = pipe.eval_step(c, vs.batch_at(i), torch.from_numpy(cands[i]),
                                   nbr_proj_table=tbl, mem_bf16=mirror)
            c, (s, n) = out_i[:2]
            sums.append(float(s))
            counts.append(float(n))
        out[proj] = (sums, counts, snapshot(c))
    return out


@functools.lru_cache(maxsize=None)
def runs(popularity, opts=()):
    """(JAX run, port run) on one stream, the pipelines built with ``opts``,
    computed once per process."""
    stream = make_stream(popularity)
    j = run_jax(*stream, opts=opts)
    return j, run_port(*stream, j["params"], j["negs"], opts=opts)


def assert_state_matches(got, want, atol=1e-4):
    for name, a, b in zip(REC_NAMES, got["rec"], want["rec"]):
        np.testing.assert_array_equal(a, b, err_msg=f"recency {name}")
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got["mem"][name], want["mem"][name], err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(got["mem"][name], want["mem"][name], rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("popularity", ["uniform", "zipf"])
def test_train_steps_match_jax(popularity):
    j, p = runs(popularity)
    diff = np.abs(p["losses"] - j["losses"])
    print(f"{popularity}: {diff.size} train steps, max loss diff {diff.max():.3g}, JAX losses "
          f"{np.round(j['losses'], 5).tolist()}")
    assert diff.size == EPOCHS * -(-E_TRAIN // B)
    assert diff.max() <= 1e-5
    assert_state_matches(p["train"], j["train"])
    assert np.abs(p["train"]["mem"]["mem"]).max() > 0.1  # the memory moved
    np.testing.assert_allclose(p["forward"], j["forward"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("proj", [False, True], ids=["raw_feats", "proj_table"])
@pytest.mark.parametrize("popularity", ["uniform", "zipf"])
def test_eval_steps_match_jax(popularity, proj):
    j, p = runs(popularity)
    (p_sums, p_counts, p_state), (j_sums, j_counts, j_state) = p[proj], j[proj]
    print(f"{popularity} proj={proj}: MRR sums port {p_sums} JAX {j_sums}, counts {p_counts}")
    assert len(p_sums) == 3
    assert p_counts == j_counts and sum(p_counts) == E_VAL
    np.testing.assert_allclose(p_sums, j_sums, rtol=0, atol=1e-5)
    assert_state_matches(p_state, j_state)


def small_run(seed=0):
    src, dst, t, edge_x, bounds, cands = make_stream("uniform", seed)
    data, dg, ts, vs = port_streams(src, dst, t, edge_x, bounds)
    rng = np.random.default_rng(seed + 1)
    negs = [rng.integers(0, N, B).astype(np.int32) for _ in range(EPOCHS * ts.num_batches)]
    return data, dg, ts, vs, cands, negs


def train_losses(pipe, carry, stream, epochs=EPOCHS):
    epoch = jit_scan_epoch(pipe.train_step, stream.batch_at, stream.num_batches)
    losses = []
    for _ in range(epochs):
        carry, ls = epoch(carry)
        losses.append(ls)
    return carry, torch.cat(losses)


def test_eid_layout_matches_feature_layout():
    data, _, ts, _, _, negs = small_run()
    losses = {}
    for mode, table in (("eid", data.edge_x), ("feature", None)):
        pipe = make_pipe(table, negs)
        _, losses[mode] = train_losses(pipe, pipe.init_carry(7), ts)
    print(f"max loss diff {float((losses['eid'] - losses['feature']).abs().max()):.3g}")
    torch.testing.assert_close(losses["eid"], losses["feature"], rtol=0, atol=1e-6)


def test_pipeline_matches_hook_train_core():
    data, dg, ts, _, _, negs = small_run()
    pipe = make_pipe(data.edge_x, negs)
    carry = pipe.init_carry(3)
    mods = copy.deepcopy(carry.params)
    carry, p_losses = train_losses(pipe, carry, ts)

    memory, encoder, decoder = mods["mem"], mods["enc"], mods["dec"]
    opt = torch.optim.Adam([p for m in (memory, encoder, decoder) for p in m.parameters()], lr=LR)
    train_core, _ = build_tgn_hook_cores(memory, encoder, decoder, opt, N, style="rowwise")
    hm = HookManager(keys=["train"])
    rnd = RandomNegativeEdgeSamplerHook(0, N, device="cpu")
    injected = iter(negs)
    rnd.draw_neg = lambda size: torch.from_numpy(next(injected).copy())
    hm.register("train", rnd)
    rec = RecencyNeighborHook(N, [K], ["edge_src", "edge_dst", "neg"],
                              ["edge_time", "edge_time", "neg_time"], edge_dim=D,
                              edge_x_full=data.edge_x, device="cpu")
    hm.register_shared(rec)
    mem_state, h_losses = memory.init_state("cpu"), []
    for _ in range(EPOCHS):
        epoch, states = hook_epoch(ts, hm, "train", dg, train_core)
        (mem_state, _), states, ls = epoch((mem_state, None), states)
        hm.adopt_states("train", states)
        h_losses.append(ls)
    h_losses = torch.cat(h_losses)
    print(f"max loss diff {float((p_losses - h_losses).abs().max()):.3g}")
    torch.testing.assert_close(p_losses, h_losses, rtol=0, atol=1e-6)
    for name, a, b in zip(REC_NAMES, carry.rec_state, rec.state):
        assert torch.equal(a, b), name
    for name in INT_FIELDS + FLOAT_FIELDS:
        assert torch.equal(getattr(carry.mem_state, name), getattr(mem_state, name)), name


@pytest.mark.parametrize("layout", ["eid", "feature"])
def test_eval_advance_state_matches_eval_step(layout):
    data, _, ts, vs, cands, negs = small_run()
    pipe = make_pipe(data.edge_x if layout == "eid" else None, negs)
    carry, _ = train_losses(pipe, pipe.init_carry(5), ts, epochs=1)
    full = pipe.flush_all(carry)
    adv = clone_state(full)
    for i in range(vs.num_batches):
        full, _ = pipe.eval_step(full, vs.batch_at(i), torch.from_numpy(cands[i]))
        adv = pipe.eval_advance_state(adv, vs.batch_at(i))
    for a, b in zip(full.rec_state, adv.rec_state):
        assert torch.equal(a, b)
    for a, b in zip(full.mem_state, adv.mem_state):
        assert torch.equal(a, b)


def test_train_step_draws_no_dropout():
    data, _, ts, _, _, negs = small_run()
    losses = []
    for dropout in (0.0, 0.1):
        pipe = make_pipe(data.edge_x, negs, dropout=dropout)
        losses.append(train_losses(pipe, pipe.init_carry(11), ts)[1])
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("kwargs, match", [
    ({"state_row_multiple": 8}, "not queued"),
])
def test_unported_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        TGNPipeline(N, D, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs, table, kv_bf16", [
    ({"dedup_staging": True}, torch.float32, False),
    ({"feat_bf16": True}, torch.bfloat16, False),
    ({"attn_bf16": True}, torch.bfloat16, True),
    ({"attn_bf16": "on"}, torch.bfloat16, True),
    ({"attn_bf16": True, "rowwise": False}, torch.float32, False),
])
def test_bf16_options_build_as_in_jax(kwargs, table, kv_bf16):
    """The table's dtype and the encoder's K/V path as the JAX constructor
    resolves them (``attn_bf16`` casts the table only on the rowwise path;
    the segment encoder has no bf16 path)."""
    edge_x = np.random.default_rng(0).normal(size=(20, D)).astype(np.float32)
    j_pipe = JPipeline(num_nodes=N, edge_dim=D, edge_x_full=jnp.asarray(edge_x), **kwargs)
    pipe = TGNPipeline(N, D, edge_x_full=edge_x, device="cpu", **kwargs)
    assert pipe.edge_x_full.dtype == table
    assert str(j_pipe.edge_x_full.dtype) == str(table).split(".")[1]
    np.testing.assert_array_equal(pipe.edge_x_full.float().numpy(),
                                  np.asarray(j_pipe.edge_x_full.astype(jnp.float32)))
    enc = pipe.init_carry(0).params["enc"]
    assert getattr(enc, "kv_bf16", False) == kv_bf16 == getattr(j_pipe.encoder, "kv_bf16", False)
    assert pipe.dedup_staging == kwargs.get("dedup_staging", False)


BF16_OPTS = {"attn_bf16": (("attn_bf16", True),),
             "feat_bf16_dedup": (("dedup_staging", True), ("feat_bf16", True))}


@pytest.mark.parametrize("name", list(BF16_OPTS))
def test_bf16_options_match_jax(name):
    j, p = runs("uniform", BF16_OPTS[name])
    diff = np.abs(p["losses"] - j["losses"])
    assert diff.size == EPOCHS * -(-E_TRAIN // B)
    mrr = lambda sums, counts: sum(sums) / max(sum(counts), 1.0)
    report = [f"{name}: max loss diff {diff.max():.3g} (first {diff[0]:.3g})"]
    for proj in (False, True):
        (p_sums, p_counts, p_state), (j_sums, j_counts, j_state) = p[proj], j[proj]
        assert p_counts == j_counts and sum(p_counts) == E_VAL
        val = abs(mrr(p_sums[:2], p_counts[:2]) - mrr(j_sums[:2], j_counts[:2]))
        test = abs(mrr(p_sums[2:], p_counts[2:]) - mrr(j_sums[2:], j_counts[2:]))
        report.append(f"proj={proj}: val MRR diff {val:.3g}, test MRR diff {test:.3g}")
        assert val <= 0.01 and test <= 0.02
        assert_state_matches(p_state, j_state, atol=np.inf)
        for name_ in ("s_raw", "d_raw"):
            np.testing.assert_array_equal(p_state["mem"][name_], j_state["mem"][name_])
    mem_gap = np.abs(p["train"]["mem"]["mem"] - j["train"]["mem"]["mem"]).max()
    print("; ".join(report) + f"; train memory max diff {mem_gap:.3g}")
    assert diff.max() <= 5e-3
    assert_state_matches(p["train"], j["train"], atol=np.inf)


def test_bf16_memory_mirror_changes_no_bit():
    """``eval_step(mem_bf16=...)`` scores and commits exactly as the eval
    without the mirror, and the mirror stays the bf16 cast of the memory."""
    data, _, ts, vs, cands, negs = small_run()
    pipe = make_pipe(data.edge_x, negs, attn_bf16=True)
    carry, _ = train_losses(pipe, pipe.init_carry(9), ts, epochs=1)
    carry = pipe.flush_all(carry)
    table = pipe.eval_proj_table(carry.params)
    assert table.dtype == torch.bfloat16 and table.shape == (data.edge_x.shape[0], EMB)
    plain, mirrored = clone_state(carry), clone_state(carry)
    mirror = pipe.eval_mem_bf16(mirrored)
    for i in range(vs.num_batches):
        cd = torch.from_numpy(cands[i])
        plain, (s0, n0) = pipe.eval_step(plain, vs.batch_at(i), cd, nbr_proj_table=table)
        mirrored, (s1, n1), mirror = pipe.eval_step(mirrored, vs.batch_at(i), cd,
                                                    nbr_proj_table=table, mem_bf16=mirror)
        assert torch.equal(s0, s1) and torch.equal(n0, n1)
        assert torch.equal(mirror.view(torch.int16),
                           mirrored.mem_state.mem.to(torch.bfloat16).view(torch.int16))
    for a, b in zip((*plain.mem_state, *plain.rec_state),
                    (*mirrored.mem_state, *mirrored.rec_state)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bf16"):
        pipe.eval_step(mirrored, vs.batch_at(0), torch.from_numpy(cands[0]),
                       mem_bf16=mirror.float())


def test_bf16_table_is_the_gather_of_the_cast():
    """On the bf16 K/V path a bf16 table gives the fp32 table's bits: the
    encoder casts the gathered rows to bf16 first."""
    data, _, ts, _, _, negs = small_run()
    losses = {}
    for stored in (torch.bfloat16, torch.float32):
        pipe = make_pipe(data.edge_x, negs, attn_bf16=True)
        assert pipe.edge_x_full.dtype == torch.bfloat16
        pipe.edge_x_full = pipe.edge_x_full.float() if stored == torch.float32 else \
            pipe.edge_x_full
        _, losses[stored] = train_losses(pipe, pipe.init_carry(4), ts, epochs=1)
    assert torch.equal(losses[torch.bfloat16], losses[torch.float32])


def test_dedup_staging_stages_the_same_rows():
    """Staging each distinct row once gives the rows staging every row
    gives: equal scores and first loss; the gradients then sum the
    duplicated rows in another order, so later losses agree to 1e-6."""
    data, _, ts, vs, _, negs = small_run()
    out = {}
    for dedup in (False, True):
        pipe = make_pipe(data.edge_x, negs, dedup_staging=dedup)
        carry, _ = train_losses(pipe, pipe.init_carry(6), ts, epochs=1)
        fwd = pipe.forward_only(carry, vs.batch_at(0))
        pipe.draw_neg = lambda rng, size, it=iter(negs): torch.from_numpy(next(it).copy())
        _, losses = train_losses(pipe, pipe.init_carry(6), ts, epochs=1)
        out[dedup] = fwd, losses
    assert torch.equal(out[False][1][0], out[True][1][0])
    torch.testing.assert_close(out[False][1], out[True][1], rtol=0, atol=1e-6)
    torch.testing.assert_close(out[False][0], out[True][0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kwargs", [
    {"attn_score_layout": "lanes"}, {"attn_score_layout": "kmajor"}, {"attn_bf16": "auto"},
    {"attn_bf16": "off"}, {"attn_bf16": False}, {"feat_bf16": False}, {"rowwise": False},
    {"packed_recency": True},
    {"packed_state": True}, {"rowwise": False, "packed_state": True},
])
def test_same_math_options_are_accepted(kwargs):
    assert TGNPipeline(N, D, device="cpu", **kwargs).num_nbrs == 10


def test_eval_only_misuse_raises():
    pipe = TGNPipeline(N, D, MEM, EMB, TIME, K, device="cpu")  # feature layout
    carry = pipe.init_carry(0)
    with pytest.raises(ValueError, match="eid layout"):
        pipe.eval_proj_table(carry.params)
    with pytest.raises(ValueError, match="attn_score_layout"):
        TGNPipeline(N, D, attn_score_layout="rows", device="cpu")
    src, dst, t, edge_x, bounds, cands = make_stream("uniform")
    _, _, _, vs = port_streams(src, dst, t, edge_x, bounds)
    with pytest.raises(ValueError, match="attn_bf16"):
        pipe.eval_step(carry, vs.batch_at(0), torch.from_numpy(cands[0]),
                       mem_bf16=torch.zeros(N + 1, MEM, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="attn_bf16"):
        pipe.eval_mem_bf16(carry)



def test_projected_table_changes_no_bit():
    """The encoder computes the edge projection as a split sum, so the
    pre-projected table gives the raw path's bits (the CPU matmul rounds
    each row alike): equal MRR sums, ties included."""
    data, _, ts, vs, cands, negs = small_run()
    pipe = make_pipe(data.edge_x, negs)
    carry, _ = train_losses(pipe, pipe.init_carry(9), ts, epochs=1)
    carry = pipe.flush_all(carry)
    table = pipe.eval_proj_table(carry.params)
    sums = {}
    for name, tbl in (("raw", None), ("table", table)):
        c, sums[name] = clone_state(carry), []
        for i in range(vs.num_batches):
            c, (s, _) = pipe.eval_step(c, vs.batch_at(i), torch.from_numpy(cands[i]),
                                       nbr_proj_table=tbl)
            sums[name].append(s)
    assert torch.equal(torch.stack(sums["raw"]), torch.stack(sums["table"]))
