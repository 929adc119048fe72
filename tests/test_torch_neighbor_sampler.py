"""Uniform neighbour sampling (``NeighborSamplerHook``) against the JAX package.

* ``temporal_csr`` of the storage: every array equal to JAX's, directed and
  undirected.
* ``sample`` against JAX ``_query`` with JAX's draws injected (fault 5:
  the two frameworks draw different numbers): ids, times and features
  exact, on rows with no candidate, with at most K and with more than K,
  including the JAX bisection's step past a row whose candidates all lie
  before the window's end (ROADMAP.md fault 16).
* ``floyd_offsets`` equals Floyd's step-by-step loop and gives K distinct
  offsets in [0, cnt).
* ``apply`` over train then val through one hook (two hops, the CSR cached
  from train), products exact against JAX's with its draws injected.
* Two epochs of TGAT's ``--sampling uniform`` flow in both packages with
  JAX's weights, negatives, link times and sampler draws injected: the
  first loss within 1e-5, every loss within 5e-3, val MRR within 0.01 per
  epoch and test MRR within 0.02. The example script runs it on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tgm_tpu import DGData as JDGData
from tgm_tpu import DGDataLoader as JLoader
from tgm_tpu import DGraph as JDGraph
from tgm_tpu.constants import PADDED_NODE_ID
from tgm_tpu.eval.metrics import mrr_sum_count as j_mrr_sum_count
from tgm_tpu.hooks import HookManager as JHookManager
from tgm_tpu.hooks import NeighborSamplerHook as JSampler
from tgm_tpu.hooks import RandomNegativeEdgeSamplerHook as JRandomNeg
from tgm_tpu.hooks import TGBNegativeEdgeSamplerHook as JTGB
from tgm_tpu.hooks import candidate_rows as j_candidate_rows
from tgm_tpu.hooks import seed_lookup as j_seed_lookup
from tgm_tpu.nn import TGAT as JTGAT
from tgm_tpu.nn import LinkPredictor as JLinkPredictor
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.data import DGDataLoader
from tgm_tpu_torch.examples.linkproppred import tgat as tgat_example
from tgm_tpu_torch.hooks import (
    HookManager,
    NeighborSamplerHook,
    RandomNegativeEdgeSamplerHook,
    TGBNegativeEdgeSamplerHook,
)
from tgm_tpu_torch.hooks.neighbors import floyd_offsets
from tgm_tpu_torch.nn import TGAT, LinkPredictor
from tgm_tpu_torch.train import (
    DeviceEdgeStream,
    build_tgat_eval_core,
    build_tgat_train_core,
    hook_epoch,
)
from tgm_tpu_torch.weights import load_tgat_params

N, E, EDGE_DIM = 60, 400, 6
SPLITS = ("train", "val", "test")


def make_stream(seed=0, n=N, e=E):
    rng = np.random.default_rng(seed)
    # Skewed popularity: some rows hold more than K entries, others few or none.
    p = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=p / p.sum())
    dst = rng.integers(0, n, e)
    dst = np.where(dst == src, (dst + 1) % n, dst)
    t = np.sort(rng.integers(0, 3 * e, e))
    edge_x = rng.normal(size=(e, EDGE_DIM)).astype(np.float32)
    return src, dst, t, edge_x, rng


def both_data(src, dst, t, edge_x):
    idx = np.stack([src, dst], 1)
    return JDGData.from_raw(t, idx, edge_x), DGData.from_raw(t, idx, edge_x)


def jax_draws(key, sizes, ks):
    """The (S_i, K_i) draws JAX's ``apply`` makes from its state ``key``,
    one per hop (``sizes`` the hop seed counts)."""
    out = []
    for S, k in zip(sizes, ks):
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        out.append(jax.random.randint(sub, (S, k), 0, jnp.int32(2**31 - 1)))
    return out


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
def test_temporal_csr_matches_jax(directed):
    src, dst, t, edge_x, _ = make_stream(1)
    jd, pd = both_data(src, dst, t, edge_x)
    for j_part, p_part in zip(jd.split(), pd.split()):
        got = DGraph(p_part)._storage.temporal_csr(directed)
        want = JDGraph(j_part)._storage.temporal_csr(directed)
        assert len(got) == len(want) == 6
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.asarray(a).dtype == np.asarray(b).dtype, i
            np.testing.assert_array_equal(a, b, err_msg=f"CSR field {i}")


@pytest.mark.parametrize("k", [1, 3, 8])
def test_sample_matches_jax_query_with_injected_draws(k):
    src, dst, t, edge_x, rng = make_stream(2)
    jd, pd = both_data(src, dst, t, edge_x)
    jdg, pdg = JDGraph(jd), DGraph(pd)
    jh = JSampler([k], ["edge_src"], ["edge_time"])
    ph = NeighborSamplerHook([k], ["edge_src"], ["edge_time"], device="cpu")
    jh.init_state(jdg)
    ph.init_state(pdg)
    seeds = np.concatenate([np.arange(-1, N + 2), rng.integers(0, N, 40)]).astype(np.int32)
    query = jax.jit(jh._query, static_argnums=3)
    counts = []
    for end_time in (-1, 0, int(t[E // 3]), int(t[E // 2]), int(t[-1]), int(t[-1]) + 7):
        key = jax.random.PRNGKey(end_time + 10)
        rand = jax.random.randint(jax.random.split(key)[1], (len(seeds), k), 0,
                                  jnp.int32(2**31 - 1))
        want = query(key, jnp.asarray(seeds), jnp.int32(end_time), k)
        got = ph.sample(torch.from_numpy(seeds), torch.tensor(end_time), k,
                        torch.from_numpy(np.array(rand)))
        for name, a, b in zip(("ids", "times", "feats"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} at end_time {end_time}")
        counts.append((got[0] != PADDED_NODE_ID).sum(1).numpy())
    counts = np.concatenate(counts)
    assert (counts == 0).any() and (counts == k).any()
    assert k == 1 or ((counts > 0) & (counts < k)).any()


def floyd_loop(rand, cnt, k):
    """The JAX package's Floyd steps, one at a time."""
    chosen = np.full(rand.shape, -1, np.int64)
    for i in range(k):
        tt = cnt - k + i
        r = rand[:, i] % np.maximum(tt + 1, 1)
        dup = (chosen == r[:, None]).any(1)
        chosen[:, i] = np.where(dup, tt, r)
    return chosen


@pytest.mark.parametrize("k", [1, 2, 5, 20])
def test_floyd_offsets_are_floyds_steps_and_distinct(k):
    rng = np.random.default_rng(k)
    S = 3000
    cnt = rng.integers(k + 1, 3 * k + 3, S)
    rand = rng.integers(0, 2**31 - 1, (S, k))
    rand[: S // 3] %= 4  # many repeated draws: long chains of taken t_i
    got = floyd_offsets(torch.from_numpy(rand).int(), torch.from_numpy(cnt), k).numpy()
    np.testing.assert_array_equal(got, floyd_loop(rand, cnt, k))
    assert ((got >= 0) & (got < cnt[:, None])).all()
    assert all(len(set(row)) == k for row in got.tolist())


def test_apply_over_train_then_val_through_one_hook_matches_jax():
    src, dst, t, edge_x, _ = make_stream(3)
    jd, pd = both_data(src, dst, t, edge_x)
    KS = [4, 3]
    jh = JSampler(KS, ["edge_src", "edge_dst"], ["edge_time", "edge_time"])
    ph = NeighborSamplerHook(KS, ["edge_src", "edge_dst"], ["edge_time", "edge_time"],
                             device="cpu")
    injected = []
    ph.draw_offsets = lambda gen, S, k: injected.pop(0)
    japply = jax.jit(jh.apply)
    n_batches = 0
    for jpart, ppart in zip(jd.split()[:2], pd.split()[:2]):  # train, then val
        jdg, pdg = JDGraph(jpart), DGraph(ppart)
        js, ps = jh.init_state(jdg), ph.init_state(pdg)
        for jb, pb in zip(JLoader(jdg, 48), DGDataLoader(pdg, 48, device="cpu")):
            S0 = 2 * jb.edge_src.shape[0]
            injected.extend(torch.from_numpy(np.array(r))
                            for r in jax_draws(js, [S0, S0 * KS[0]], KS))
            js, jb = japply(js, jb)
            ps, pb = ph.apply(ps, pb)
            for name in ("seed_nids", "seed_times", "nbr_nids", "nbr_edge_time", "nbr_edge_x"):
                for hop, (a, b) in enumerate(zip(getattr(pb, name), getattr(jb, name))):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                                  err_msg=f"{name}[{hop}] @ {n_batches}")
            n_batches += 1
    assert not injected and n_batches >= 8
    # The CSR stayed train's: val queried train's edges only.
    assert ph._csr[1].shape[0] == 2 * len(pd.split()[0].edge_index)


# ---------------------------------------------------------------------- #
# Two TGAT --sampling uniform epochs in both packages
# ---------------------------------------------------------------------- #
BSIZE, Q, KS, TIME, EMB, EPOCHS, LR = 50, 4, [4, 3], 8, 16, 2, 1e-3


def jax_tgat_cores(encoder, decoder, opt, node_x):
    """The JAX example's ``train_core`` and ``eval_core`` (examples/linkproppred/tgat.py:146-212)."""

    def encode(p, batch):
        return encoder.apply(p["enc"], node_x, batch.seed_nids, batch.seed_times,
                             batch.nbr_nids, batch.nbr_edge_x, batch.nbr_edge_time)

    def bce(logits, target, mask):
        w = mask.astype(jnp.float32)
        return jnp.sum(optax.sigmoid_binary_cross_entropy(logits, target) * w) / jnp.maximum(
            jnp.sum(w), 1.0)

    def train_core(carry, batch):
        params, opt_state = carry
        B = batch.edge_src.shape[0]

        def loss_fn(p):
            z = encode(p, batch)
            pos = decoder.apply(p["dec"], z[:B], z[B:2 * B])
            neg = decoder.apply(p["dec"], z[:B], z[2 * B:3 * B])
            return (bce(pos, jnp.ones_like(pos), batch.edge_valid)
                    + bce(neg, jnp.zeros_like(neg), batch.edge_valid))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state), loss

    def eval_core(params, batch):
        B, Qn = batch.neg_batch_list.shape
        z = encode(params, batch)
        rows_c, found = j_candidate_rows(j_seed_lookup(batch.seed_nids[0], N),
                                         batch.neg_batch_list, z.shape[0])
        pos = decoder.apply(params["dec"], z[:B], z[B:2 * B])
        neg = decoder.apply(params["dec"],
                            jnp.repeat(z[:B][:, None, :], Qn, axis=1).reshape(B * Qn, -1),
                            z[rows_c].reshape(B * Qn, -1)).reshape(B, Qn)
        return params, j_mrr_sum_count(
            pos, neg, neg_valid=(batch.neg_batch_list != PADDED_NODE_ID) & found,
            edge_valid=batch.edge_valid)

    return train_core, eval_core


def run_jax_uniform(data, node_x, cands):
    dgs = dict(zip(SPLITS, (JDGraph(d) for d in data.split())))
    hm = JHookManager(keys=list(SPLITS))
    train_dst = dgs["train"].edge_dst
    hm.register("train", JRandomNeg(low=int(train_dst.min()), high=int(train_dst.max())))
    for split in ("val", "test"):
        hm.register(split, JTGB(candidates=cands[split]))
    sampler = JSampler(KS, ["edge_src", "edge_dst", "neg"], ["edge_time", "edge_time", "neg_time"])
    hm.register_shared(sampler)
    encoder = JTGAT(node_dim=1, edge_dim=EDGE_DIM, time_dim=TIME, embed_dim=EMB,
                    num_layers=len(KS), n_heads=2, dropout=0.0)
    decoder = JLinkPredictor(node_dim=EMB)
    x = jnp.asarray(node_x)
    S = 6
    z = lambda *s: jnp.zeros(s, jnp.int32)
    hops = ([z(S), z(S * KS[0])], [z(S), z(S * KS[0])], [z(S, KS[0]), z(S * KS[0], KS[1])],
            [jnp.zeros((S, KS[0], EDGE_DIM)), jnp.zeros((S * KS[0], KS[1], EDGE_DIM))],
            [z(S, KS[0]), z(S * KS[0], KS[1])])
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    params = {"enc": encoder.init(k1, x, *hops),
              "dec": decoder.init(k2, jnp.zeros((1, EMB)), jnp.zeros((1, EMB)))}
    init_params = params
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    train_core, eval_core = jax_tgat_cores(encoder, decoder, opt, x)
    streams = {s: JStream(dgs[s], BSIZE) for s in SPLITS}
    steps = {}
    injected = {"neg": [], "neg_time": [], "draws": []}

    def step_fn(split, core):
        if (split, core) not in steps:
            fn, _ = hm.as_transform(split, dgs[split])
            idx = hm._key_to_hooks[split].index(sampler)

            @jax.jit
            def step(states, carry, i):
                batch = streams[split].batch_at(i)
                B = batch.edge_src.shape[0]
                S0 = 3 * B if split == "train" else 2 * B + B * Q
                draws = jax_draws(states[idx], [S0, S0 * KS[0]], KS)
                states, batch = fn(states, batch)
                carry, out = (carry, 0.0) if core is None else core(carry, batch)
                drawn = batch.neg if split == "train" else batch.neg_time
                return states, carry, out, drawn, draws

            steps[(split, core)] = step
        return steps[(split, core)]

    def run(split, core, carry):
        _, states = hm.as_transform(split, dgs[split])
        outs = []
        for i in range(streams[split].num_batches):
            states, carry, out, drawn, draws = step_fn(split, core)(states, carry, i)
            outs.append(out)
            injected["neg" if split == "train" else "neg_time"].append(np.asarray(drawn))
            injected["draws"].extend(np.asarray(d) for d in draws)
        hm.adopt_states(split, states)
        return carry, outs

    mrr = lambda outs: sum(float(s) for s, _ in outs) / max(sum(float(c) for _, c in outs), 1.0)
    epochs = []
    for _ in range(EPOCHS):
        (params, opt_state), losses = run("train", train_core, (params, opt_state))
        params, outs = run("val", eval_core, params)
        epochs.append(dict(losses=[float(v) for v in losses], val=mrr(outs)))
        hm.reset_state()
    run("train", None, None)
    run("val", None, None)
    _, outs = run("test", eval_core, params)
    return init_params, epochs, mrr(outs), injected


def run_port_uniform(data, node_x, cands, params, injected):
    dgs = dict(zip(SPLITS, (DGraph(d) for d in data.split())))
    negs, neg_times, draws = (iter(injected[k]) for k in ("neg", "neg_time", "draws"))
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
    sampler = NeighborSamplerHook(KS, ["edge_src", "edge_dst", "neg"],
                                  ["edge_time", "edge_time", "neg_time"], device="cpu")
    sampler.draw_offsets = lambda gen, S, k: torch.from_numpy(next(draws).copy())
    hm.register_shared(sampler)
    encoder = TGAT(1, EDGE_DIM, TIME, EMB, len(KS), n_heads=2, dropout=0.0)
    decoder = LinkPredictor(node_dim=EMB)
    load_tgat_params(params, encoder, decoder)
    opt = torch.optim.Adam([*encoder.parameters(), *decoder.parameters()], lr=LR)
    x = torch.from_numpy(node_x)
    train_core = build_tgat_train_core(encoder, decoder, opt, x)
    eval_core = build_tgat_eval_core(encoder, decoder, x, N)
    streams = {s: DeviceEdgeStream(dgs[s], BSIZE, device="cpu") for s in SPLITS}

    def run(split, core, carry):
        epoch, states = hook_epoch(streams[split], hm, split, dgs[split], core)
        carry, states, outs = epoch(carry, states)
        hm.adopt_states(split, states)
        return carry, outs

    mrr = lambda outs: float(outs[0].sum() / outs[1].sum().clamp_min(1.0))
    replay = lambda carry, batch: (carry, torch.zeros(()))
    epochs = []
    for _ in range(EPOCHS):
        _, losses = run("train", train_core, (None,))
        _, outs = run("val", eval_core, None)
        epochs.append(dict(losses=losses.tolist(), val=mrr(outs)))
        hm.reset_state()
    run("train", replay, None)
    run("val", replay, None)
    _, outs = run("test", eval_core, None)
    assert next(negs, None) is None and next(neg_times, None) is None
    assert next(draws, None) is None
    return epochs, mrr(outs)


def test_two_uniform_tgat_epochs_match_the_jax_example_flow():
    src, dst, t, edge_x, rng = make_stream(4)
    node_x = rng.normal(size=(N, 1)).astype(np.float32)
    jd, pd = both_data(src, dst, t, edge_x)
    _, val, test = pd.split()
    cands = {"val": rng.integers(0, N, (val.num_edge_events, Q)),
             "test": rng.integers(0, N, (test.num_edge_events, Q))}
    params, j_epochs, j_test, injected = run_jax_uniform(jd, node_x, cands)
    p_epochs, p_test = run_port_uniform(pd, node_x, cands, params, injected)
    gaps = [np.abs(np.subtract(p["losses"], j["losses"])) for p, j in zip(p_epochs, j_epochs)]
    val_gap = max(abs(p["val"] - j["val"]) for p, j in zip(p_epochs, j_epochs))
    test_gap = abs(p_test - j_test)
    losses = np.concatenate([j["losses"] for j in j_epochs])
    print(f"uniform TGAT: {losses.size} train steps, first-loss gap {gaps[0][0]:.3g}, max loss "
          f"gap {max(g.max() for g in gaps):.3g}; val MRR {[j['val'] for j in j_epochs]} (gap "
          f"{val_gap:.3g}), test MRR {j_test:.6f} (gap {test_gap:.3g})")
    assert len(j_epochs[0]["losses"]) >= 5
    assert gaps[0][0] <= 1e-5
    assert max(g.max() for g in gaps) <= 5e-3
    assert val_gap <= 0.01 and test_gap <= 0.02
    assert all(0.0 < p["val"] <= 1.0 for p in p_epochs) and 0.0 < p_test <= 1.0
    assert losses.max() - losses.min() > 1e-3


def test_example_script_runs_uniform_sampling_on_the_cpu(tmp_path):
    log = tmp_path / "metrics.jsonl"
    out = tgat_example.main(["--dataset", "synthetic-120-800", "--device", "cpu",
                             "--sampling", "uniform", "--n-nbrs", "5", "5", "--time-dim", "8",
                             "--embed-dim", "16", "--log-file-path", str(log)])
    assert np.isfinite(out["loss"]) and out["loss"] > 0
    assert 0.0 < out["val_mrr"] <= 1.0 and 0.0 < out["test_mrr"] <= 1.0
    assert [json.loads(s)["metric"] for s in log.read_text().splitlines()] == [
        "loss", "val_mrr", "test_mrr"]
