"""Three places where the port's API had drifted from the JAX package.

* ``tgm_tpu_torch.train.scanned_hook_epoch`` exists with the JAX arguments
  (``donate``, ``compiler_options`` and ``unroll`` take no effect) and runs
  the epoch ``hook_epoch`` runs: outputs equal bit for bit.
* ``eval.mrr`` of an empty batch without ``edge_valid`` is nan, the
  ``jnp.mean`` of nothing, as in JAX; with an all-invalid ``edge_valid`` it
  is 0 in both.
* ``tgn_train_commit(memory, mem_state, batch, num_nodes, staged=None)``
  flushes the batch's src | dst nodes, then stores the messages: against
  the JAX function's flush route (integer fields exact, floats within
  1e-6), and within 1e-6 of the port's staged route.

Sizes: 60 nodes, batches of 32 edges, memory/time dims 8/6, 4-dim messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu.eval.metrics import mrr as j_mrr
from tgm_tpu.nn.encoder.tgn import TGNMemory as JMemory
from tgm_tpu.nn.encoder.tgn import TGNMemoryState as JState
from tgm_tpu.train.programs import tgn_train_commit as j_train_commit
from tgm_tpu_torch import DGData, DGraph
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.eval.metrics import mrr
from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook
from tgm_tpu_torch.nn import TGNMemory, TGNMemoryState
from tgm_tpu_torch.train import DeviceEdgeStream, hook_epoch, scanned_hook_epoch, tgn_train_commit
from tgm_tpu_torch.weights import load_tgn_memory_params

N, B, MEM, TIME, R = 60, 32, 8, 6, 4
FIELDS = ("mem", "last_update", "s_other", "s_t", "s_raw", "s_valid",
          "d_other", "d_t", "d_raw", "d_valid")


def test_scanned_hook_epoch_takes_the_jax_arguments():
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(0, 500, 200))
    data = DGData.from_raw(t, rng.integers(0, N, (200, 2)), rng.normal(size=(200, R)))
    dg = DGraph(data)
    stream = DeviceEdgeStream(dg, B, device="cpu")
    assert hook_epoch is scanned_hook_epoch

    def step(carry, batch):
        return carry + 1, batch.nbr_nids[0].sum() + batch.nbr_edge_time[0].sum()

    outs = []
    for kw in ({}, {"donate": False, "compiler_options": {"xla_opt": 1}, "unroll": 4}):
        hm = HookManager(keys=["train"])
        hm.register_shared(RecencyNeighborHook(N, [3], ["edge_src"], ["edge_time"],
                                               edge_x_full=data.edge_x, device="cpu"))
        epoch, states = scanned_hook_epoch(stream, hm, "train", dg, step, **kw)
        carry, _, out = epoch(0, states)
        assert carry == stream.num_batches
        outs.append(out)
    assert torch.equal(outs[0], outs[1]) and int(outs[0].sum()) > 0


def test_mrr_of_an_empty_batch_is_nan_as_in_jax():
    empty = np.zeros(0, np.float32)
    want = float(j_mrr(jnp.asarray(empty), jnp.zeros((0, 3))))
    got = float(mrr(torch.from_numpy(empty), torch.zeros((0, 3))))
    assert np.isnan(want) and np.isnan(got)
    pos = np.array([0.5, 0.1], np.float32)
    neg = np.array([[0.2, 0.9], [0.3, 0.0]], np.float32)
    none_valid = np.zeros(2, bool)
    assert float(mrr(torch.from_numpy(pos), torch.from_numpy(neg),
                     edge_valid=torch.from_numpy(none_valid))) == 0.0 == float(
        j_mrr(jnp.asarray(pos), jnp.asarray(neg), edge_valid=jnp.asarray(none_valid)))
    np.testing.assert_allclose(float(mrr(torch.from_numpy(pos), torch.from_numpy(neg))),
                               float(j_mrr(jnp.asarray(pos), jnp.asarray(neg))), rtol=0,
                               atol=1e-7)


def state_and_batch(seed):
    rng = np.random.default_rng(seed)
    n1 = N + 1
    last = rng.integers(0, 100, n1).astype(np.int32)
    st = dict(mem=rng.normal(size=(n1, MEM)).astype(np.float32), last_update=last,
              s_other=rng.integers(-1, N, n1).astype(np.int32),
              s_t=(last + rng.integers(0, 100, n1)).astype(np.int32),
              s_raw=rng.normal(size=(n1, R)).astype(np.float32), s_valid=rng.random(n1) < 0.7,
              d_other=rng.integers(-1, N, n1).astype(np.int32),
              d_t=(last + rng.integers(0, 100, n1)).astype(np.int32),
              d_raw=rng.normal(size=(n1, R)).astype(np.float32), d_valid=rng.random(n1) < 0.7)
    for name, fill in zip(FIELDS, (0, 0, -1, 0, 0, False, -1, 0, 0, False)):
        st[name][N] = fill
    valid = np.arange(B) < B - 5
    src = np.where(valid, rng.integers(0, N, B), -1).astype(np.int32)
    dst = np.where(valid, rng.integers(0, N, B), -1).astype(np.int32)
    t = np.where(valid, np.sort(rng.integers(200, 300, B)), 0).astype(np.int32)
    x = rng.normal(size=(B, R)).astype(np.float32)
    return st, (src, dst, t, valid, x)


def test_train_commit_without_staged_rows_flushes_as_in_jax():
    st, (src, dst, t, valid, x) = state_and_batch(1)
    jmem = JMemory(num_nodes=N, raw_msg_dim=R, memory_dim=MEM, time_dim=TIME)
    js = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    p = jmem.init(jax.random.PRNGKey(2), js, jnp.zeros(4, jnp.int32))
    jb = JBatch(*(jnp.asarray(a) for a in (src, dst, t, valid)))
    jb.edge_x = jnp.asarray(x)
    want = jax.jit(lambda s, b: j_train_commit(jmem, {"mem": p}, s, b, N))(js, jb)

    memory = TGNMemory(N, R, MEM, TIME)
    load_tgn_memory_params(p, memory)
    up = lambda a: torch.from_numpy(a.copy())
    batch = DGBatch(up(src), up(dst), up(t), up(valid), edge_x=up(x))
    state = TGNMemoryState(**{k: up(v) for k, v in st.items()})
    got = tgn_train_commit(memory, state, batch, N)  # no staged rows: the flush route
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in ("mem", "s_raw", "d_raw"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert not np.array_equal(got.mem.numpy(), st["mem"])

    # The staged route commits the rows the forward staged: the same state.
    state = TGNMemoryState(**{k: up(v) for k, v in st.items()})
    nodes = torch.cat([batch.edge_src, batch.edge_dst])
    with torch.no_grad():
        staged = memory.stage(state, torch.where(torch.cat([batch.edge_valid] * 2), nodes, N))
    again = tgn_train_commit(memory, state, batch, N, staged)
    for name in FIELDS:
        torch.testing.assert_close(getattr(again, name), getattr(got, name), rtol=0, atol=1e-6)
