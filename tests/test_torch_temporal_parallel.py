"""``tgm_tpu_torch.parallel.temporal`` against ``tgm_tpu.parallel.temporal``.

The JAX tests' stream (32 nodes, 8 batches of 16, 4-dim edge features;
``tests/test_temporal_parallel.py::_setup``) and pipeline (memory and
embed 8, time 4, K = 3, feature recency layout: kernel K4, the push and the
store commit), built in both packages from the same numpy draws. The port
loads the JAX ``init_carry``'s weights and is fed the negatives JAX draws:
every JAX step splits the carry's key once, so a span that starts from a
copy of the start carry draws the same negatives as every other span.
The port's generators are told apart by their state (``Draws``), so a
copied generator draws what the original would have.

Tolerances: losses within 1e-5, integer state exact, float state within
1e-5 (fp32, different summation orders); ``merge_stale_carries`` exact on
the same per-span carries (JAX's, converted), including the int32 wrap of
its keys (ROADMAP fault 26); the pipelined eval bit-equal to the port's
sequential eval, and its MRR sums within 1e-5 of JAX's.

Each test computes its JAX reference itself (one jitted program each), so
no reference is computed twice when the tests run on several workers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.core.graph import DGraph as JDGraph
from tgm_tpu.data.dg_data import DGData as JDGData
from tgm_tpu.parallel import temporal as jt
from tgm_tpu.train import DeviceEdgeStream as JStream
from tgm_tpu.train import TGNPipeline as JPipeline
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.nn import TGNMemoryState
from tgm_tpu_torch.parallel import temporal as pt
from tgm_tpu_torch.train import (
    DeviceEdgeStream,
    TGATPipeline,
    TGNPipeline,
    jit_scan_epoch,
    scan_epoch,
)

N, BS, NB, D = 32, 16, 8, 4
INT_FIELDS = ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid")


def stream_arrays(num_batches=NB, bsize=BS):
    rng = np.random.default_rng(0)
    E = num_batches * bsize
    return (np.sort(rng.integers(0, 1000, E)), rng.integers(0, 32, (E, 2)),
            rng.normal(size=(E, 4)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_setup(num_batches=NB):
    t, ei, x = stream_arrays(num_batches)
    stream = JStream(JDGraph(JDGData.from_raw(edge_time=t, edge_index=ei, edge_x=x,
                                              time_delta="s")), BS)
    pipe = JPipeline(num_nodes=N, edge_dim=D, memory_dim=8, embed_dim=8, time_dim=4, num_nbrs=3,
                     neg_high=N)
    carry0 = pipe.init_carry(jax.random.PRNGKey(0))
    negs, key = [], carry0.rng
    for _ in range(2 * NB):
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (BS,), pipe.neg_low, pipe.neg_high,
                                                  dtype=jnp.int32)))
    return pipe, stream, carry0, negs


class Draws:
    """``draw_neg`` handing out JAX's negatives: a generator that has drawn
    j times (from the seed the carry's generator starts at) draws
    ``negs[j]``; it is told by its state, so copies keep counting."""

    def __init__(self, negs, seed=0):
        g = torch.Generator().manual_seed(seed)
        self.index = {}
        for j in range(len(negs)):
            self.index[bytes(g.get_state().numpy())] = j
            torch.randint(0, 2, (1,), generator=g)
        self.negs = negs

    def __call__(self, rng, size):
        j = self.index[bytes(rng.get_state().numpy())]
        torch.randint(0, 2, (1,), generator=rng)
        return torch.from_numpy(self.negs[j].copy())


def port_setup(num_batches=NB, jax_draws=True):
    """The port's pipeline, stream and start carry; with ``jax_draws`` the
    JAX ``init_carry``'s weights and JAX's negatives, else its own."""
    t, ei, x = stream_arrays(num_batches)
    stream = DeviceEdgeStream(DGraph(DGData.from_raw(t, ei, x)), BS, device="cpu")
    pipe = TGNPipeline(N, D, 8, 8, 4, 3, neg_high=N, device="cpu")
    if not jax_draws:
        return pipe, stream, pipe.init_carry(0)
    _, _, carry0, negs = jax_setup(num_batches)
    pipe.draw_neg = Draws(negs)
    return pipe, stream, pipe.init_carry(0, params=jax.device_get(carry0.params))


def mem_arrays(mem):
    return {k: np.asarray(v) for k, v in mem._asdict().items()}


def assert_state_close(got_mem, want_mem, got_rec, want_rec, atol=1e-5):
    got, want = mem_arrays(got_mem), mem_arrays(want_mem)
    for k in want:
        if k in INT_FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
    for i, (a, b) in enumerate(zip(got_rec, want_rec)):
        a, b = np.asarray(a), np.asarray(b)
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"rec {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"rec {i}")


def span_carry(tree, s):
    return jax.tree_util.tree_map(lambda a: a[s], tree)


def port_carry(pipe, jcarry):
    """A port carry holding one JAX carry's weights, Adam state and state."""
    params = jax.device_get(jcarry.params)
    carry = pipe.init_carry(0, params=params)
    adam = jcarry.opt_state[0]
    moments = []
    for tree in (adam.mu, adam.nu):
        mods = pipe.init_carry(0, params=jax.device_get(tree)).params
        moments.append(dict(mods.named_parameters()))
    for name, p in carry.params.named_parameters():
        carry.opt_state.state[p] = {"step": torch.tensor(float(adam.count)),
                                    "exp_avg": moments[0][name].detach().clone(),
                                    "exp_avg_sq": moments[1][name].detach().clone()}
    mem = TGNMemoryState(*(torch.from_numpy(np.array(v)) for v in jcarry.mem_state))
    rec = tuple(torch.from_numpy(np.array(v)) for v in jcarry.rec_state)
    return carry._replace(mem_state=mem, rec_state=rec)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,k", [(10, 3), (8, 4), (2, 4), (0, 3), (7, 1), (551, 4)])
def test_split_spans(n, k):
    assert pt.split_spans(n, k) == jt.split_spans(n, k)


def test_chain_equals_plain_scan():
    """The port's chain over 4 spans is bit-equal to its plain epoch and
    within 1e-5 of JAX's ``chain_epoch``, run as one span (its 4-span form
    equals it: ``tests/test_temporal_parallel.py``; one scan compiles in a
    quarter of the time)."""
    jpipe, jstream, carry0, _ = jax_setup()
    jc, jl = jax.jit(lambda c: jt.chain_epoch(jpipe.train_step, jstream.batch_at, c,
                                              jstream.num_batches, 1))(carry0)
    pipe, stream, c0 = port_setup()
    c_plain, l_plain = scan_epoch(pipe.train_step, stream.batch_at, pt.copy_carry(c0),
                                  stream.num_batches)
    c_chain, l_chain = pt.chain_epoch(pipe.train_step, stream.batch_at, c0, stream.num_batches,
                                      4)
    assert torch.equal(l_plain, l_chain)
    for a, b in zip(c_plain.mem_state + c_plain.rec_state, c_chain.mem_state + c_chain.rec_state):
        assert torch.equal(a, b)
    gap = float(np.abs(l_chain.numpy() - np.asarray(jl)).max())
    print(f"chain: {l_chain.numel()} losses, max gap to JAX {gap:.3g}")
    assert gap <= 1e-5
    assert_state_close(c_chain.mem_state, jc.mem_state, c_chain.rec_state, jc.rec_state)


def test_stale_parallel_and_merge():
    jpipe, jstream, carry0, _ = jax_setup()
    n_spans = 4
    jcarries, jlosses = jax.jit(lambda c: jt.stale_parallel_epoch(
        jpipe.train_step, jstream.batch_at, c, jstream.num_batches, n_spans))(carry0)
    jmerged = jt.merge_stale_carries(jcarries, num_nodes=N)
    pipe, stream, c0 = port_setup()
    carries, losses = pt.stale_parallel_epoch(pipe.train_step, stream.batch_at, c0,
                                              stream.num_batches, n_spans)
    assert losses.shape == (n_spans, stream.num_batches // n_spans)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0, atol=1e-5)
    for s, c in enumerate(carries):
        j = span_carry(jcarries, s)
        assert_state_close(c.mem_state, j.mem_state, c.rec_state, j.rec_state)
    merged = pt.merge_stale_carries(carries, num_nodes=N)
    assert type(merged.mem_state) is TGNMemoryState
    lu_all = torch.stack([c.mem_state.last_update for c in carries])
    assert torch.equal(merged.mem_state.last_update, lu_all.max(0).values)
    assert_state_close(merged.mem_state, jmerged.mem_state, merged.rec_state, jmerged.rec_state)
    for name, p in merged.params.named_parameters():
        assert torch.isfinite(p).all(), name

    # The merge itself, exact on JAX's per-span carries converted to the port.
    conv = [port_carry(pipe, span_carry(jcarries, s)) for s in range(n_spans)]
    assert_merge_exact(pipe, conv, jcarries, jmerged)

    # ROADMAP fault 26: times past 2^31 / n_spans wrap the int32 keys.
    big = 1_700_000_000
    lu = np.asarray(jcarries.mem_state.last_update)
    lu = np.where(lu > 0, lu + big, lu).astype(np.int32)
    wp = (np.asarray(jcarries.rec_state[3]) * 100_000_000).astype(np.int32)
    wrapped = jcarries._replace(mem_state=jcarries.mem_state._replace(last_update=jnp.asarray(lu)),
                                rec_state=jcarries.rec_state[:3] + (jnp.asarray(wp),))
    key64 = lu.astype(np.int64) * n_spans + np.arange(n_spans)[:, None]
    key32 = lu * np.int32(n_spans) + np.arange(n_spans, dtype=np.int32)[:, None]
    assert (key64.argmax(0) != key32.argmax(0)).any()  # the wrap moves some winners
    for s, c in enumerate(conv):
        c.mem_state.last_update.copy_(torch.from_numpy(lu[s]))
        c.rec_state[3].copy_(torch.from_numpy(wp[s]))
    assert_merge_exact(pipe, conv, wrapped, jt.merge_stale_carries(wrapped, num_nodes=N))


def assert_merge_exact(pipe, carries, jcarries, jmerged):
    merged = pt.merge_stale_carries(carries, num_nodes=N)
    for k, v in mem_arrays(merged.mem_state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jmerged.mem_state, k)), err_msg=k)
    for i, (a, b) in enumerate(zip(merged.rec_state, jmerged.rec_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"rec {i}")
    want = pipe.init_carry(0, params=jax.device_get(jmerged.params)).params
    for (name, p), (_, q) in zip(merged.params.named_parameters(), want.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=name)
    adam = jmerged.opt_state[0]
    mu = dict(pipe.init_carry(0, params=jax.device_get(adam.mu)).params.named_parameters())
    for name, p in merged.params.named_parameters():
        st = merged.opt_state.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name].detach().numpy(), name)
        assert float(st["step"]) == float(adam.count) == float(carries[0].opt_state.state[
            dict(carries[0].params.named_parameters())[name]]["step"])


def test_stale_resync_single_span_is_sequential():
    pipe, stream, c0 = port_setup(jax_draws=False)
    _, ref = scan_epoch(pipe.train_step, stream.batch_at, pt.copy_carry(c0), stream.num_batches)
    carry, round_losses = pt.stale_resync_epoch(pipe.train_step, stream.batch_at, c0,
                                                stream.num_batches, n_spans=1, num_nodes=N,
                                                resync_rounds=4)
    assert len(round_losses) == 4
    assert torch.equal(torch.cat([r.reshape(-1) for r in round_losses]), ref)


def check_resync_against_jax(merge_params_each_round):
    """Two rounds over two spans in both packages: losses, state and
    weights within 1e-5."""
    jpipe, jstream, carry0, _ = jax_setup()
    jcarry, jrounds = jax.jit(lambda c: jt.stale_resync_epoch(
        jpipe.train_step, jstream.batch_at, c, jstream.num_batches, n_spans=2, num_nodes=N,
        resync_rounds=2, merge_params_each_round=merge_params_each_round))(carry0)
    pipe, stream, c0 = port_setup()
    carry, rounds = pt.stale_resync_epoch(pipe.train_step, stream.batch_at, c0,
                                          stream.num_batches, n_spans=2, num_nodes=N,
                                          resync_rounds=2,
                                          merge_params_each_round=merge_params_each_round)
    assert len(rounds) == len(jrounds) == 2
    for r, jr in zip(rounds, jrounds):
        assert r.shape == jr.shape and torch.isfinite(r).all()
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    assert_state_close(carry.mem_state, jcarry.mem_state, carry.rec_state, jcarry.rec_state)
    want = pipe.init_carry(0, params=jax.device_get(jcarry.params)).params
    for (name, p), (_, q) in zip(carry.params.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_stale_resync_runs_and_merges():
    check_resync_against_jax(True)


def test_stale_resync_state_only_matches_jax():
    """``merge_params_each_round=False`` (the JAX package's state-only
    resync, ``tools/staleness_study.py``) against JAX's."""
    check_resync_against_jax(False)


def test_stale_resync_state_only_keeps_each_spans_weights():
    """``merge_params_each_round=False``: after round 1 every span carries on
    from the merged state with its own weights, Adam and generator, so its
    round-2 losses are those of the span's own carry continued on the merged
    state; the epoch's merge averages the spans' final weights."""
    pipe, stream, c0 = port_setup(jax_draws=False)
    nb = stream.num_batches
    carry, rounds = pt.stale_resync_epoch(pipe.train_step, stream.batch_at, pt.copy_carry(c0),
                                          nb, n_spans=2, num_nodes=N, resync_rounds=2,
                                          merge_params_each_round=False)
    spans, first = pt.stale_parallel_epoch(pipe.train_step, stream.batch_at, c0, nb // 2, 2)
    assert torch.equal(rounds[0], first)
    merged = pt.merge_stale_carries(spans, N)
    finals, want = [], []
    for s, c in enumerate(spans):
        c = c._replace(mem_state=pt.copy_carry(merged).mem_state,
                       rec_state=pt.copy_carry(merged).rec_state)
        for j, i in enumerate(range(nb // 2 + 2 * s, nb // 2 + 2 * s + 2)):
            c, loss = pipe.train_step(c, stream.batch_at(i))
            want.append(loss)
        finals.append(c)
    assert torch.equal(rounds[1].reshape(-1), torch.stack(want))
    for (name, p), *qs in zip(carry.params.named_parameters(),
                              *(c.params.parameters() for c in finals)):
        assert torch.equal(p, torch.stack(qs).mean(0)), name


def eval_fns(pipe, stream, rows):
    """(num_batches, score_fn, advance_fn); ``rows(i)`` is batch i's candidates."""
    nb = stream.num_batches

    def score_fn(c, i):
        return pipe.eval_step(c, stream.batch_at(i), rows(i))

    def advance_fn(c, i):
        return pipe.eval_advance_state(c, stream.batch_at(i))

    return nb, score_fn, advance_fn


def test_pipelined_eval_exact():
    """Pipelined span-handoff eval == the sequential eval, bit for bit, and
    JAX's within 1e-5 (7 batches over 3 spans: uneven on purpose)."""
    jpipe, jstream, carry0, _ = jax_setup(7)
    cands = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (7 * BS, 5), 0, N,
                                          dtype=jnp.int32))
    jc = jnp.asarray(cands)
    nb, j_score, j_adv = eval_fns(jpipe, jstream,
                                  lambda i: jax.lax.dynamic_slice(jc, (i * BS, 0), (BS, 5)))
    (jsums, jcnts), jvalid = jax.jit(lambda c: jt.pipelined_eval_epoch(
        j_adv, j_score, c, nb, 3))(jax.jit(jpipe.flush_all)(carry0))

    pipe, stream, c0 = port_setup(7)
    c0 = pipe.flush_all(c0)
    tc = torch.from_numpy(cands.copy())
    nb, score_fn, advance_fn = eval_fns(pipe, stream, lambda i: tc[i * BS : (i + 1) * BS])
    _, (sum_chain, cnt_chain) = scan_epoch(lambda c, i: score_fn(c, i), lambda i: i,
                                           pt.copy_carry(c0), nb)
    (sums, cnts), valid = pt.pipelined_eval_epoch(advance_fn, score_fn, c0, nb, 3)
    assert sums.shape == (3, 3) and valid.tolist() == np.asarray(jvalid).tolist()
    assert torch.equal(sums[valid], sum_chain) and torch.equal(cnts[valid], cnt_chain)
    assert (sums[~valid] == 0).all() and (cnts[~valid] == 0).all()
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=0, atol=1e-5)


def test_eval_advance_state_matches_eval_step_state():
    """advance_fn evolves the carry exactly as the full eval step."""
    pipe, stream, c0 = port_setup(jax_draws=False)
    c0 = pipe.flush_all(c0)
    cands = torch.randint(0, N, (BS, 5), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32)
    b = stream.batch_at(0)
    c_full, _ = pipe.eval_step(pt.copy_carry(c0), b, cands)
    c_adv = pipe.eval_advance_state(pt.copy_carry(c0), b)
    for a, bb in zip(c_full.mem_state + c_full.rec_state, c_adv.mem_state + c_adv.rec_state):
        assert torch.equal(a, bb)
    moved = [not torch.equal(a, bb) for a, bb in zip(c0.mem_state, c_adv.mem_state)]
    assert any(moved)  # the copies left the start carry as it was, and the state moved


def test_copy_carry_is_independent():
    pipe, stream, c0 = port_setup(jax_draws=False)
    before = [x.clone() for x in c0.mem_state + c0.rec_state]
    w = [p.detach().clone() for p in c0.params.parameters()]
    c1 = pt.copy_carry(c0)
    c1, _ = pipe.train_step(c1, stream.batch_at(0))
    assert all(torch.equal(a, b) for a, b in zip(before, c0.mem_state + c0.rec_state))
    assert all(torch.equal(a, b) for a, b in zip(w, c0.params.parameters()))
    assert not c0.opt_state.state and c1.opt_state.state
    assert c1.opt_state.param_groups[0]["params"][0] is next(c1.params.parameters())
    # The copy's generator draws what the original's would.
    assert torch.equal(torch.randint(0, 9, (5,), generator=pt.copy_carry(c0).rng),
                       torch.randint(0, 9, (5,), generator=c0.rng))


def test_tgat_pipeline_scan_learns():
    rng = np.random.default_rng(0)
    E, n = 256, 24
    data = DGData.from_raw(np.sort(rng.integers(0, 500, E)), rng.integers(0, n, (E, 2)),
                           rng.normal(size=(E, 4)).astype(np.float32))
    stream = DeviceEdgeStream(DGraph(data), 32, device="cpu")
    node_x = rng.normal(size=(n, 3)).astype(np.float32)
    pipe = TGATPipeline(num_nodes=n, edge_dim=4, node_x=node_x, num_nbrs=(4, 3), time_dim=8,
                        embed_dim=16, lr=1e-3, neg_high=n, device="cpu")
    carry = pipe.init_carry(0)
    epoch = jit_scan_epoch(pipe.train_step, stream.batch_at, stream.num_batches)
    carry, l1 = epoch(carry)
    carry, l2 = epoch(carry)
    carry, l3 = epoch(carry)
    assert torch.isfinite(l3).all()
    assert float(l3.mean()) < float(l1.mean())
