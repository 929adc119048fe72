"""``tgn_store_commit`` on the CPU (its plain version) against the JAX
``tgn_store_messages`` (its jnp path, as the JAX package runs on the CPU).

Inputs come from numpy seeds: a JAX state whose stores already hold
messages (the dump row at its initial values, which the JAX store resets it
to), then one batch through both. Tolerance: exact equality on all ten
fields (integer plan and stores; the fp32 raw rows are copies).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgm_tpu.nn.encoder.tgn import TGNMemoryState as JState
from tgm_tpu.nn.encoder.tgn import tgn_store_messages as j_store
from tgm_tpu_torch.nn import TGNMemoryState
from tgm_tpu_torch.ops import tgn_store_commit

N, M = 40, 3  # nodes (N1 = 41 with the dump row) and memory width


def j_state(rng, R):
    """A JAX state with random stored messages on rows 0..N-1, the dump row
    as ``init_state`` leaves it."""
    n1 = N + 1

    def ints(lo, hi):
        x = rng.integers(lo, hi, n1).astype(np.int32)
        x[-1] = 0
        return x

    def other():
        x = ints(0, N)
        x[-1] = -1  # PADDED_NODE_ID
        return x

    raw = lambda: np.where(np.arange(n1)[:, None] < N, rng.normal(size=(n1, R)), 0).astype(
        np.float32)
    flag = lambda: (rng.random(n1) < 0.5) & (np.arange(n1) < N)
    s = JState(mem=rng.normal(size=(n1, M)).astype(np.float32), last_update=ints(0, 50),
               s_other=other(), s_t=ints(0, 50), s_raw=raw(), s_valid=flag(),
               d_other=other(), d_t=ints(0, 50), d_raw=raw(), d_valid=flag())
    return JState(*map(jnp.asarray, s))


def batch(rng, case):
    """(src, dst, t, raw, valid) for one case, int32/fp32/bool numpy arrays."""
    E, R = dict(E1=(1, 6), E2500=(2500, 172), R0=(30, 0), R172=(60, 172)).get(case, (60, 6))
    owners = 4 if case == "dups" else N
    src = rng.integers(0, owners, E).astype(np.int32)
    dst = rng.integers(0, owners, E).astype(np.int32)
    if case == "self_loop":
        dst[::2] = src[::2]
    if case == "ties":
        t = np.full(E, 70, np.int32)
        t[rng.random(E) < 0.3] = 69
    elif case == "sorted_ties":
        t = np.sort(rng.integers(60, 64, E)).astype(np.int32)
    elif case == "negative_t":  # the JAX plan's max starts at -1: lower times never win
        t = rng.integers(-3, 1, E).astype(np.int32)
    else:  # unsorted times, with ties among few values
        t = rng.integers(60, 60 + max(2, E // 8), E).astype(np.int32)
    valid = rng.random(E) < 0.8
    if case == "all_invalid":
        valid[:] = False
    src[~valid & (rng.random(E) < 0.5)] = -1  # padding ids where the loader pads
    dst[~valid & (rng.random(E) < 0.5)] = -1
    raw = rng.normal(size=(E, R)).astype(np.float32)
    return src, dst, t, raw, valid


CASES = ["dups", "ties", "sorted_ties", "unsorted", "negative_t", "all_invalid", "E1",
         "E2500", "R0", "R172", "self_loop", "dump_row"]


@pytest.mark.parametrize("case", CASES)
def test_store_commit_matches_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    src, dst, t, raw, valid = batch(rng, case)
    js = j_state(rng, raw.shape[1])
    want = j_store(js, *(jnp.asarray(x) for x in (src, dst, t, raw, valid)))
    state = TGNMemoryState(*(torch.from_numpy(np.array(x)) for x in js))
    if case == "dump_row":  # the port never writes the dump row: any contents survive
        for name in ("s_other", "s_t", "d_other", "d_t"):
            getattr(state, name)[-1] = 12345
        state.s_raw[-1], state.d_raw[-1] = 7.0, -7.0
        state.s_valid[-1] = state.d_valid[-1] = True
    before = [x.clone() for x in state]
    launches = tgn_store_commit.launches
    got = tgn_store_commit(state, *(torch.from_numpy(x) for x in (src, dst, t, raw, valid)))
    assert tgn_store_commit.launches == launches  # the CPU runs the plain version
    assert got is state  # written in place
    for name, g, w, b in zip(TGNMemoryState._fields, got, want, before):
        w = np.asarray(w)
        if case == "dump_row":
            np.testing.assert_array_equal(g[-1].numpy(), b[-1].numpy(), err_msg=name)
            g, w = g[:-1], w[:-1]
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    changed = [not torch.equal(g, b) for g, b in zip(got, before)]
    assert not changed[0] and not changed[1]  # mem and last_update are not written
    if case == "all_invalid":
        assert not any(changed)
    else:
        assert any(changed)


def test_store_commit_checks_its_inputs():
    rng = np.random.default_rng(0)
    src, dst, t, raw, valid = map(torch.from_numpy, batch(rng, "dups"))
    state = TGNMemoryState(*(torch.from_numpy(np.array(x)) for x in j_state(rng, 6)))
    with pytest.raises(TypeError):
        tgn_store_commit(state, src.long(), dst, t, raw, valid)
    with pytest.raises(TypeError):
        tgn_store_commit(state, src, dst, t, raw.double(), valid)
    with pytest.raises(ValueError):
        tgn_store_commit(state, src, dst, t, raw[:, :5], valid)
    with pytest.raises(ValueError):
        tgn_store_commit(state, src[:-1], dst, t, raw, valid)
    with pytest.raises(ValueError):
        tgn_store_commit(state, src, dst, t, raw[:, 0], valid)
    meta = TGNMemoryState(*(x.to("meta") for x in state))
    with pytest.raises(ValueError, match="unsupported device"):
        tgn_store_commit(meta, *(x.to("meta") for x in (src, dst, t, raw, valid)))
    with pytest.raises(ValueError):
        tgn_store_commit(state, src.to("meta"), dst, t, raw, valid)


def test_store_commit_empty_batch_writes_nothing():
    rng = np.random.default_rng(1)
    state = TGNMemoryState(*(torch.from_numpy(np.array(x)) for x in j_state(rng, 6)))
    before = [x.clone() for x in state]
    e = lambda dtype, *shape: torch.zeros(shape, dtype=dtype)
    tgn_store_commit(state, e(torch.int32, 0), e(torch.int32, 0), e(torch.int32, 0),
                     e(torch.float32, 0, 6), e(torch.bool, 0))
    assert all(torch.equal(g, b) for g, b in zip(state, before))
