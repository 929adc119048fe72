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
from tgm_tpu_torch.core.batch import DGBatch
from tgm_tpu_torch.nn import TGNMemoryState, tgn_pack_state
from tgm_tpu_torch.parallel import (
    Sharding,
    batch_shardings,
    data_model_mesh,
    make_mesh,
    place,
    shard_leading_axis,
    sharded_tgat_train_step,
    sharded_tgn_train_step,
    tgn_carry_shardings,
    tgn_carry_shardings_2d,
    tp_param_shardings,
)
from tgm_tpu_torch.train import TGATPipeline, TGNPipeline

ROOT = Path(__file__).resolve().parents[1]
STEPS, SHIFT = 3, 1000
INT_KEYS = ("rec0", "rec1", "rec3", "mem.last_update", "mem.s_other", "mem.s_t", "mem.s_valid",
            "mem.d_other", "mem.d_t", "mem.d_valid")


def _tiny_tgat(batch_size=16):
    """``tests/test_parallel.py::_tiny_tgat`` (one device)."""
    rng = np.random.default_rng(0)
    N, D = 32, 4
    node_x = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    edge_x_full = jnp.asarray(rng.normal(size=(256, D)).astype(np.float32))
    pipe = JTGAT(num_nodes=N, edge_dim=D, node_x=node_x, num_nbrs=(4, 4), time_dim=8,
                 embed_dim=16, n_heads=2, lr=1e-3, neg_low=0, neg_high=N,
                 edge_x_full=edge_x_full)
    B = batch_size
    batch = JBatch(
        edge_src=jnp.asarray(rng.integers(0, N, B), jnp.int32),
        edge_dst=jnp.asarray(rng.integers(0, N, B), jnp.int32),
        edge_time=jnp.asarray(np.sort(rng.integers(1, 100, B)), jnp.int32),
        edge_valid=jnp.ones(B, bool),
    )
    batch.edge_ids = jnp.arange(B, dtype=jnp.int32)
    return pipe, batch


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


def jax_case(pipe, batch):
    """Weights, negatives, losses and final state of STEPS single-device steps."""
    carry = pipe.init_carry(jax.random.PRNGKey(0))
    params = plain(jax.device_get(carry.params))
    negs, key = [], carry.rng
    for _ in range(STEPS):
        key, k_neg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(k_neg, (batch.edge_src.shape[0],),
                                                  pipe.neg_low, pipe.neg_high, dtype=jnp.int32)))
    step = jax.jit(pipe.train_step)
    losses = []
    for i in range(STEPS):
        carry, loss = step(carry, batch.replace(edge_time=batch.edge_time + i * SHIFT))
        losses.append(float(loss))
    return {"params": params, "negs": negs}, {"losses": losses, "state": state_arrays(carry)}


@pytest.fixture(scope="module")
def jax_refs():
    cases = {"tgn_feature": _tiny_setup(batch_size=16),
             "tgn_eid": _tiny_setup(batch_size=16, eid_mode=True),
             "tgat_eid": _tiny_tgat()}
    inputs, refs = {}, {}
    for name, (pipe, batch) in cases.items():
        inputs[name], refs[name] = jax_case(pipe, batch)
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
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5,
                                   err_msg=case)
        np.testing.assert_allclose(got["replay_losses"], want["losses"], rtol=0, atol=1e-5)
        assert all(np.isfinite(got["losses"]))
        assert set(got["state"]) == set(want["state"])
        for k, v in want["state"].items():
            if k in INT_KEYS or v.dtype.kind != "f":
                np.testing.assert_array_equal(got["state"][k], v, err_msg=f"{case} {k}")
            else:
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


def test_unported_configurations_raise():
    mesh = StubMesh([2], ("data",), [0])
    for kw in (dict(packed_state=True), dict(rowwise=False)):
        with pytest.raises(NotImplementedError, match="10e"):
            sharded_tgn_train_step(tiny_pipe(**kw), mesh)
    pipe = tiny_pipe()
    carry = pipe.init_carry(0)
    packed = carry._replace(mem_state=tgn_pack_state(carry.mem_state))
    assert not isinstance(packed.mem_state, TGNMemoryState)
    with pytest.raises(NotImplementedError, match="10e"):
        sharded_tgn_train_step(pipe, mesh)(packed, None)


@pytest.mark.parametrize("kw", [dict(feat_bf16=True), dict(attn_bf16=True),
                                dict(dedup_staging=True)])
def test_bf16_pipelines_are_not_sharded_yet(kw):
    """ROADMAP item 10e lists the bf16 options' sharded steps."""
    mesh = StubMesh([2], ("data",), [0])
    with pytest.raises(NotImplementedError, match="10e"):
        sharded_tgn_train_step(tiny_pipe(edge_x_full=np.zeros((4, 3), np.float32), **kw), mesh)
    if "dedup_staging" not in kw:
        tgat = TGATPipeline(10, 3, np.zeros((10, 1), np.float32), device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="10e"):
            sharded_tgat_train_step(tgat, mesh)
