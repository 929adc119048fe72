"""``tgm_tpu_torch.parallel``'s meshes, layouts and node-sharded steps
against the JAX package's single-device steps.

The JAX package runs ``jax.jit(pipe.train_step)`` over a mesh of virtual
CPU devices and checks it against one device (``tests/test_parallel.py``).
The port writes the sharded steps out with ``torch.distributed``
collectives, so its test spawns real processes: ``tools/torch_multihost_sim.py``
starts P gloo ranks through a ``file://`` rendezvous, once with P = 2 (a
1-D ``data`` mesh) and once with P = 4 (a 2 x 2 ``(data, model)`` mesh,
the parameter matrices split over ``model``), and runs three sharded steps
on one batch, each time 1,000 s later (a batch replayed at its old times
builds recency rows in no time order, where JAX's jnp query and the port's
kernels differ: ROADMAP fault 1), for each case: TGN in the feature layout
(kernel K4, the push,
the store commit) and the eid layout (K1 with the features fused) at
``__graft_entry__._tiny_setup``'s sizes, and TGAT (two hops of K1) at the
JAX test's ``_tiny_tgat`` sizes. The ranks load JAX's weights and draw
JAX's negatives; the state is gathered back from the shards. The tool's
TGAT cases in the feature layout (K4) and over the side-augmented table,
which the JAX test does not run, are held to the port's own single
process (``rec["ok"]``).

The JAX tests' cases: ``test_make_mesh_default`` and
``test_make_mesh_2d`` are the meshes of the two spawns and
``test_make_mesh_asks_for_no_more_ranks_than_exist``;
``test_sharded_tgn_train_step_matches_single_device`` and
``test_sharded_multi_step_state_consistency`` the TGN cases of P = 2;
``test_sharded_tgat_train_step_matches_single_device`` and
``test_sharded_tgat_2d_mesh_step`` the TGAT case of P = 2 and 4;
``test_shard_leading_axis_specs`` its own; ``tests/test_multihost.py``'s
two-process run the P = 2 spawn.

Tolerances: every loss within 1e-5 of JAX's single-device step, integer
state (recency rings, write positions, message-store fields, last updates)
exact, memory and raw messages within 1e-5; the tool's own single-process
replay of the port within 1e-5 as well.
"""

import json
import os
import pickle
import subprocess
import sys
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_setup
from tgm_tpu.core.batch import DGBatch as JBatch
from tgm_tpu.train import TGATPipeline as JTGAT
from tgm_tpu.train import TGNPipeline as JTGN
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.hooks.neighbors import recency_pk_init, recency_pk_update
from tgm_tpu_torch.nn.encoder.tgn import (
    TGNPackedState,
    tgn_init_state,
    tgn_mean_init_state,
    tgn_pack_state,
    tgn_store_messages_packed,
)
from tgm_tpu_torch.parallel import (
    Sharding,
    batch_shardings,
    data_model_mesh,
    make_mesh,
    place,
    shard_leading_axis,
    sharded_tgat_train_step,
    sharded_tgn_train_step,
    tgat_carry_shardings,
    tgn_carry_shardings,
    tgn_carry_shardings_2d,
    tp_param_shardings,
)
from tgm_tpu_torch.parallel.mesh import MeshAxis
from tgm_tpu_torch.parallel.spmd import _events, _pack, _push_owned, _Rows, _store_owned, _unpack
from tgm_tpu_torch.train import TGNPipeline

ROOT = Path(__file__).resolve().parents[1]
STEPS, SHIFT = 3, 1000
INT_KEYS = ("rec0", "rec1", "rec3", "mem.last_update", "mem.s_other", "mem.s_t", "mem.s_valid",
            "mem.d_other", "mem.d_t", "mem.d_valid", "mem.meta")
BF16_LOSS_TOL = 5e-3  # the bf16 training band against JAX


def _tiny_tgat(batch_size=16, aug=False, **opts):
    """``tests/test_parallel.py::_tiny_tgat`` (one device) with the
    ``TGATPipeline`` options ``opts``; ``aug``: over the side-augmented table
    of random endpoints, the tool's ``tiny_tgat(layout="aug")`` draws."""
    rng = np.random.default_rng(0)
    N, D, E = 32, 4, 256
    node_x = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    edge_x_full = jnp.asarray(rng.normal(size=(E, D)).astype(np.float32))
    B = batch_size
    batch = JBatch(
        edge_src=jnp.asarray(rng.integers(0, N, B), jnp.int32),
        edge_dst=jnp.asarray(rng.integers(0, N, B), jnp.int32),
        edge_time=jnp.asarray(np.sort(rng.integers(1, 100, B)), jnp.int32),
        edge_valid=jnp.ones(B, bool),
    )
    batch.edge_ids = jnp.arange(B, dtype=jnp.int32)
    ends = None
    if aug:
        ends = (rng.integers(0, N, E), rng.integers(0, N, E))
        ends[0][:B], ends[1][:B] = np.asarray(batch.edge_src), np.asarray(batch.edge_dst)
    pipe = JTGAT(num_nodes=N, edge_dim=D, node_x=node_x, num_nbrs=(4, 4), time_dim=8,
                 embed_dim=16, n_heads=2, lr=1e-3, neg_low=0, neg_high=N,
                 edge_x_full=edge_x_full, edge_ends_full=ends, **opts)
    return pipe, batch


def _tiny_tgn(eid_mode, **opts):
    """``__graft_entry__._tiny_setup(batch_size=16)`` with the ``TGNPipeline``
    options ``opts``."""
    pipe, batch = _tiny_setup(batch_size=16, eid_mode=eid_mode)
    return JTGN(num_nodes=64, edge_dim=16, memory_dim=32, embed_dim=32, time_dim=16, num_nbrs=4,
                neg_low=0, neg_high=64, edge_x_full=pipe.edge_x_full, **opts), batch


def plain(tree):
    """A flax tree as nested dicts of numpy arrays (the tool imports no JAX)."""
    if isinstance(tree, Mapping):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def state_arrays(carry):
    out = {f"rec{i}": np.asarray(x) for i, x in enumerate(carry.rec_state)}
    if hasattr(carry, "mem_state"):
        out.update({f"mem.{k}": np.asarray(v) for k, v in carry.mem_state._asdict().items()})
    return out


def jax_case(pipe, batch, bf16=False):
    """Weights, negatives, losses and final state of STEPS single-device steps
    (``bf16``: compiled with XLA's excess precision off, so each bf16 op
    rounds where the JAX source says, as the port does)."""
    carry = pipe.init_carry(jax.random.PRNGKey(0))
    params = plain(jax.device_get(carry.params))
    negs, key = [], carry.rng
    for _ in range(STEPS):
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (batch.edge_src.shape[0],),
                                                  pipe.neg_low, pipe.neg_high, dtype=jnp.int32)))
    batches = [batch.replace(edge_time=batch.edge_time + i * SHIFT) for i in range(STEPS)]
    step = jax.jit(pipe.train_step)
    if bf16:
        step = step.lower(carry, batches[0]).compile(
            compiler_options={"xla_allow_excess_precision": False})
    losses = []
    for b in batches:
        carry, loss = step(carry, b)
        losses.append(float(loss))
    return {"params": params, "negs": negs}, {"losses": losses, "state": state_arrays(carry)}


@pytest.fixture(scope="module")
def jax_refs():
    bf16 = dict(feat_bf16=True, attn_bf16=True)
    cases = {"tgn_feature": _tiny_setup(batch_size=16),
             "tgn_eid": _tiny_setup(batch_size=16, eid_mode=True),
             "tgat_eid": _tiny_tgat(),
             "tgn_packed": _tiny_tgn(True, packed_state=True, packed_recency=True),
             "tgn_packed_feature": _tiny_tgn(False, packed_state=True),
             "tgn_segment": _tiny_tgn(True, rowwise=False),
             "tgn_segment_feature": _tiny_tgn(False, rowwise=False, packed_state=True),
             "tgn_attn_bf16": _tiny_tgn(False, attn_bf16=True),
             "tgn_bf16_eid": _tiny_tgn(True, dedup_staging=True, **bf16),
             "tgat_bf16": _tiny_tgat(**bf16),
             "tgat_aug_bf16": _tiny_tgat(aug=True, **bf16)}
    inputs, refs = {}, {}
    for name, (pipe, batch) in cases.items():
        inputs[name], refs[name] = jax_case(pipe, batch, bf16="bf16" in name)
    return inputs, refs


def run_sims(tmp_path, worlds, inputs):
    """The tool at each world size, all at once: {world: (record, dump)}."""
    inp = tmp_path / "in.pkl"
    inp.write_bytes(pickle.dumps(inputs))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    procs = {w: subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "torch_multihost_sim.py"), "--num-processes",
         str(w), "--device", "cpu", "--out", str(tmp_path / f"p{w}.json"), "--inputs", str(inp), "--dump",
         str(tmp_path / f"p{w}.pkl")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for w in worlds}
    try:
        outs = {w: q.communicate(timeout=300) for w, q in procs.items()}
    finally:
        for q in procs.values():
            if q.poll() is None:
                q.kill()
                q.wait()
    for w, q in procs.items():
        assert q.returncode == 0, outs[w][0][-2000:] + outs[w][1][-4000:]
    return {w: (json.loads((tmp_path / f"p{w}.json").read_text()),
                pickle.loads((tmp_path / f"p{w}.pkl").read_bytes())) for w in worlds}


def test_sharded_steps_match_jax(jax_refs, tmp_path):
    """At P = 2 and at P = 4 (the two spawns run at once), the sharded TGN
    (both recency layouts) and TGAT steps reproduce JAX's single-device
    losses and state rows over three steps; each mesh is the one asked for;
    the port's single-process replay agrees too."""
    inputs, refs = jax_refs
    for world, (rec, dump) in run_sims(tmp_path, (2, 4), inputs).items():
        check_world(world, rec, dump, refs)


def check_world(world, rec, dump, refs):
    print(json.dumps({k: v for k, v in rec.items() if k != "cases"}),
          {c: (v["max_abs_diff_loss"], v["max_abs_diff_state"], v["split_params"])
           for c, v in rec["cases"].items()})
    assert rec["ok"] and rec["num_processes"] == world and rec["backend"] == "gloo"
    if world == 2:
        assert (rec["mesh_shape"], rec["mesh_axes"]) == ([2], ["data"])
    else:
        assert (rec["mesh_shape"], rec["mesh_axes"]) == ([2, 2], ["data", "model"])
    for case, want in refs.items():
        got = dump[case]
        assert rec["cases"][case]["split_params"] > 0 if world == 4 else True
        assert rec["cases"][case]["params_whole"]
        bf16 = "bf16" in case
        tol = BF16_LOSS_TOL if bf16 else 1e-5
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=tol,
                                   err_msg=case)
        np.testing.assert_allclose(got["replay_losses"], want["losses"], rtol=0, atol=tol)
        assert all(np.isfinite(got["losses"]))
        assert set(got["state"]) == set(want["state"])
        for k, v in want["state"].items():
            if k in INT_KEYS or v.dtype.kind != "f":
                np.testing.assert_array_equal(got["state"][k], v, err_msg=f"{case} {k}")
            elif not bf16:
                np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=1e-5,
                                           err_msg=f"{case} {k}")
        if case.startswith("tgn"):
            assert np.abs(got["state"]["mem.mem"]).max() > 0.01  # the memory moved


def test_make_mesh_asks_for_no_more_ranks_than_exist():
    with pytest.raises(ValueError):
        make_mesh([16], ("data",))
    with pytest.raises(ValueError):
        data_model_mesh(4, 2)


class StubMesh:
    """A mesh as one rank of it sees it, for the layouts alone (no group)."""

    def __init__(self, sizes, names, coords):
        self.mesh_dim_names, self.sizes, self.coords = names, sizes, coords

    def get_group(self, name):
        return None

    def size(self, dim):
        return self.sizes[dim]

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]


def test_shard_leading_axis_specs():
    mesh = StubMesh([8], ("data",), [0])
    tree = {"a": torch.zeros((16, 4)), "b": torch.zeros(())}
    sh = shard_leading_axis(mesh, tree)
    assert sh["a"] == Sharding(mesh, ("data", None))
    assert sh["b"].spec == ()


def tiny_pipe(**kw):
    return TGNPipeline(10, 3, memory_dim=4, embed_dim=4, time_dim=2, num_nbrs=2, neg_high=10,
                       device="cpu", **kw)


def test_tp_param_shardings_split_dim_0_where_it_divides():
    mesh = StubMesh([2, 2], ("data", "model"), [0, 1])
    carry = tiny_pipe().init_carry(0)
    layout = tgn_carry_shardings_2d(mesh, carry)
    for name, p in carry.params.named_parameters():
        split = p.dim() >= 2 and p.shape[0] % 2 == 0
        assert layout.params[name].spec == (("model",) + (None,) * (p.dim() - 1) if split else ())
        assert layout.opt_state[name]["exp_avg"] == layout.params[name]
        assert layout.opt_state[name]["step"].spec == ()
    assert tp_param_shardings(mesh, {"w": torch.zeros(3, 4)})["w"].spec == ()
    assert all(s.dump_row for s in layout.mem_state + layout.rec_state)
    # Placed on model rank 1: Adam holds that rank's rows of the split weights.
    placed = place(carry, layout)
    masters = placed.opt_state.param_groups[0]["params"]
    for (name, p), m in zip(carry.params.named_parameters(), masters):
        if layout.params[name].spec:
            k = p.shape[0] // 2
            assert torch.equal(m, p[k:])
        else:
            assert m is p


@pytest.mark.parametrize("P", [1, 3])
def test_place_keeps_each_ranks_rows_and_its_dump_row(P):
    pipe = tiny_pipe()
    carry = pipe.init_carry(0)
    for i, x in enumerate(carry.mem_state):
        x.copy_(torch.arange(x.numel()).reshape(x.shape).to(x.dtype))
    batch = DGBatch(torch.arange(7, dtype=torch.int32), torch.arange(7, dtype=torch.int32),
                    torch.arange(7, dtype=torch.int32), torch.ones(7, dtype=torch.bool))
    rows, edges = [], []
    for r in range(P):
        mesh = StubMesh([P], ("data",), [r])
        placed = place(carry, tgn_carry_shardings(mesh, carry))
        assert placed.params is carry.params and placed.opt_state is carry.opt_state
        for got, whole in zip(placed.mem_state, carry.mem_state):
            assert torch.equal(got[-1], whole[-1])  # its own dump row
        rows.append(placed.mem_state.mem[:-1])
        b = place(batch, batch_shardings(mesh, batch))
        assert b.global_size == 7 and b.global_offset == sum(len(e) for e in edges)
        edges.append(b.edge_src)
    assert torch.equal(torch.cat(rows), carry.mem_state.mem[:-1])
    assert torch.equal(torch.cat(edges), batch.edge_src)
    assert [len(e) for e in edges] == ([7] if P == 1 else [3, 2, 2])


@pytest.mark.parametrize("width", [4, 5, 172, 173])
def test_bf16_rows_cross_the_exchange_bit_exact(width):
    """bf16 rows travel as their own bits, two to an int32 column (an odd
    row padded with one), beside fp32, int32 and bool ones: every bit back."""
    g = torch.Generator().manual_seed(width)
    x = (torch.randn((6, width), generator=g) * 1e3).to(torch.bfloat16)
    x[0, 0], x[1, -1], x[2, 0] = float("nan"), -0.0, float("inf")
    kv = torch.randn((6, 2, width), generator=g).to(torch.bfloat16)
    likes = [torch.arange(6, dtype=torch.int32), x, torch.randn((6, 3), generator=g),
             torch.rand(6, generator=g) > 0.5, kv, torch.empty((6, 0), dtype=torch.bfloat16)]
    buf = _pack(likes)
    assert buf.dtype == torch.int32
    assert buf.shape[1] == 1 + (width + 1) // 2 + 3 + 1 + width
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for a, b in zip(_unpack(buf, likes), likes):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(bits.get(b.dtype, b.dtype)), b.view(bits.get(b.dtype, b.dtype)))


def _stream_batch(rng, N, E, t0):
    """One batch of the owned-write test: ids with PAD rows (invalid), tied
    times, raw messages and edge ids."""
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    valid = rng.random(E) > 0.15
    src = np.where(valid, rng.integers(0, N, E), -1)
    dst = np.where(valid, rng.integers(0, N, E), -1)
    return {"src": i32(src), "dst": i32(dst), "t": i32(t0 + np.sort(rng.integers(0, 5, E))),
            "valid": torch.as_tensor(valid), "eids": i32(rng.permutation(E) + t0)}, \
        torch.as_tensor(rng.normal(size=(E, 3)).astype(np.float32))


@pytest.mark.parametrize("P", [2, 3])
def test_owned_packed_store_and_push_equal_one_device(P):
    """Each of P ranks writes the whole batches into its own rows (the packed
    message store and the packed recency push); the ranks' rows put back
    together, and the last rank's dump row, equal one device's writes."""
    N, M, R, K = 10, 4, 3, 3
    rng = np.random.default_rng(P)
    batches = [_stream_batch(rng, N, 24, 100 * i) for i in range(3)]
    state = tgn_pack_state(tgn_init_state(N, M, R, "cpu"))
    rec = recency_pk_init(N, K, "cpu")
    shards = []
    for r in range(P):
        rows = _Rows(N, MeshAxis(StubMesh([P], ("data",), [r]), "data"))
        part = lambda x: torch.cat([x[rows.lo : rows.hi], x[N:]]).clone()
        shards.append((rows, TGNPackedState(*map(part, state)), tuple(map(part, rec))))
    for w, raw in batches:
        tgn_store_messages_packed(state, w["src"], w["dst"], w["t"], raw, w["valid"])
        recency_pk_update(rec, w["src"], w["dst"], w["t"], w["eids"], w["valid"], directed=False)
        for rows, st, rc in shards:
            _store_owned(rows, st, w, raw)
            _push_owned(rows, rc, _events(w, w["eids"]))
    assert bool(state.meta[:N, 3].any()) and bool((rec[0][:N, :, 0] >= 0).any())
    for i, whole in enumerate(tuple(state) + tuple(rec)):
        parts = [(tuple(st) + tuple(rc))[i] for _, st, rc in shards]
        got = torch.cat([x[:-1] for x in parts] + [parts[-1][-1:]])
        assert torch.equal(got, whole), i


# The pipeline options the sharded steps take beyond the rowwise fp32 ones.
ONE_RANK_CASES = ["tgn_packed", "tgn_packed_feature", "tgn_segment", "tgn_segment_feature",
                  "tgn_attn_bf16", "tgn_bf16_eid", "tgat_bf16", "tgat_aug_bf16"]


@pytest.mark.parametrize("case", ONE_RANK_CASES)
def test_sharded_step_on_one_rank_equals_train_step(case):
    """On one rank (a StubMesh, no group) the sharded step of each option is
    the pipeline's own ``train_step``: bit-equal after the first step, and
    within the tool's bounds (integer state exact) after three."""
    from tools.torch_multihost_sim import (
        BF16_LOSS_TOL,
        TOL,
        build,
        max_gap,
        max_rel_gap,
        state_arrays,
    )

    mesh = StubMesh([1], ("data",), [0])
    dev = torch.device("cpu")
    runs = []
    for sharded in (False, True):
        pipe, batches, carry = build(case, dev, None)
        step = pipe.train_step
        if sharded:
            is_tgat = case.startswith("tgat")
            carry = place(carry, (tgat_carry_shardings if is_tgat else tgn_carry_shardings)(
                mesh, carry))
            step = (sharded_tgat_train_step if is_tgat else sharded_tgn_train_step)(pipe, mesh)
            batches = [place(b, batch_shardings(mesh, b)) for b in batches]
        losses, states = [], []
        for b in batches:
            carry, loss = step(carry, b)
            losses.append(float(loss))
            states.append(state_arrays(carry))
        runs.append((losses, states))
    (ref, ref_states), (got, got_states) = runs
    assert got[0] == ref[0]
    assert max_gap(got_states[0], ref_states[0]) == 0.0
    bf16 = "bf16" in case
    assert max(abs(a - b) for a, b in zip(got, ref)) <= (BF16_LOSS_TOL if bf16 else TOL)
    last, ref_last = got_states[-1], ref_states[-1]
    assert (max_rel_gap(last, ref_last) <= 5e-3) if bf16 else (max_gap(last, ref_last) <= TOL)
    for k, v in ref_last.items():
        if v.dtype.kind != "f":
            np.testing.assert_array_equal(last[k], v, err_msg=k)


def test_mean_memory_carry_raises():
    """No pipeline of either package builds a mean-memory carry, so the
    sharded TGN step refuses one."""
    pipe = tiny_pipe()
    carry = pipe.init_carry(0)
    mean = carry._replace(mem_state=tgn_mean_init_state(10, 4, 3, device="cpu"))
    with pytest.raises(TypeError, match="TGNMeanMemoryState"):
        sharded_tgn_train_step(pipe, StubMesh([1], ("data",), [0]))(mean, None)
