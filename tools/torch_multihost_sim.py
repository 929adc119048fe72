"""Node-sharded TGN and TGAT train steps of the PyTorch port over P processes.

The counterpart of ``tools/multihost_sim.py`` for ``tgm_tpu_torch``: it
spawns P ranks of one ``torch.distributed`` group (gloo, or NCCL for one
rank on the card), reached through a ``file://`` rendezvous (no port, so
several runs can share a machine), builds the mesh with the port's own
``initialize_distributed`` / ``make_mesh`` (P = 2: a 1-D ``data`` mesh;
P = 4: a 2 x 2 ``(data, model)`` mesh), places each case's carry and batch
with ``parallel.sharding`` and runs three ``sharded_*_train_step`` steps
on one batch, as the JAX tool does, but each time ``SHIFT`` seconds later
than the last (``step_batch``), so the stream stays chronological: a batch
replayed at its old times builds recency rows in no time order, where the
JAX package's jnp query and the port's kernels differ (ROADMAP fault 1).
Rank 0 replays the same steps in one process with the pipeline's own
``train_step`` and compares the losses and the state rows gathered back
from the ranks.

Cases (``TINY``), at the JAX package's test sizes
(``__graft_entry__._tiny_setup`` and ``tests/test_parallel.py::_tiny_tgat``,
same numpy draws): TGN in the feature layout (kernel K4, the push and the
store commit) and in the eid layout (K1 with the features fused), TGAT in
the eid layout (two hops of K1), in the feature layout (K4) and over the
side-augmented table; then the other pipeline options: TGN's packed memory
state with packed recency (K1's pre-gathered entry, no push or store-commit
launch) and in the feature layout, the segment route (``rowwise=False``)
in the eid layout and in the feature layout on the packed state,
``attn_bf16`` in the feature layout, ``feat_bf16`` + ``attn_bf16`` +
``dedup_staging`` in the eid layout, and TGAT's ``feat_bf16`` +
``attn_bf16`` in the eid layout and over the side-augmented table; and two
TGN cases on the first data rank's rows alone (``ONE_RANK``). The wiki
cases (``WIKI``, below) run the eid layout, the segment route, both packed
layouts and ``attn_bf16`` in the feature layout, each trained and frozen.

Usage:
    python tools/torch_multihost_sim.py --num-processes 2 --out sim.json   # on the card
    python tools/torch_multihost_sim.py --num-processes 4 --device cpu --out sim.json
    python tools/torch_multihost_sim.py ... --inputs in.pkl --dump out.pkl
    python tools/torch_multihost_sim.py ... --cases tgn_eid_wiki tgn_eid_wiki_frozen

``--inputs``: a pickle of ``{case: {"params": numpy tree, "negs": [arrays]}}``
(weights in the JAX package's tree layout and the negatives to draw);
``--dump``: rank 0 writes every loss and the gathered state there. The
JSON output holds the losses, the single-process replay's, the largest
differences (of the state after the first step and after the last), ms a
step of both (the steps after the first) and rank 0's kernel launches (each
rank must launch what one device does, ``step_launches``); the exit code
is 1 where a case is not ``ok``: its losses or float state differ by more
than 1e-5 (the bf16 cases: losses by 1e-4, float state by 5e-3 * max |x|;
the trained wiki cases: see ``WIKI_LOSS_TOL``) or its integer state differs
at all. The ranks run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# The tiny cases: (model, recency layout, pipeline options).
TINY = {
    "tgn_feature": ("tgn", "feature", {}),
    "tgn_eid": ("tgn", "eid", {}),
    "tgat_eid": ("tgat", "eid", {}),
    "tgat_feature": ("tgat", "feature", {}),
    "tgat_aug": ("tgat", "aug", {}),
    "tgn_packed": ("tgn", "eid", dict(packed_state=True, packed_recency=True)),
    "tgn_packed_feature": ("tgn", "feature", dict(packed_state=True)),
    "tgn_segment": ("tgn", "eid", dict(rowwise=False)),
    "tgn_segment_feature": ("tgn", "feature", dict(rowwise=False, packed_state=True)),
    # bench_scaling.py's pipeline as the JAX package resolves it on its chip.
    "tgn_attn_bf16": ("tgn", "feature", dict(attn_bf16=True)),
    "tgn_bf16_eid": ("tgn", "eid", dict(feat_bf16=True, attn_bf16=True, dedup_staging=True)),
    "tgat_bf16": ("tgat", "eid", dict(feat_bf16=True, attn_bf16=True)),
    # The side-augmented table in bf16: rows of 3 + 4 = 7 elements, an odd width.
    "tgat_aug_bf16": ("tgat", "aug", dict(feat_bf16=True, attn_bf16=True)),
    # Batches on the first data rank's rows alone (``ONE_RANK``): the other
    # ranks own no requested row, and with one edge their slice is empty,
    # yet every rank calls each collective as often as the others.
    "tgn_one_rank": ("tgn", "eid", dict(feat_bf16=True, attn_bf16=True, dedup_staging=True)),
    "tgn_segment_one_rank": ("tgn", "eid", dict(rowwise=False, packed_state=True,
                                                packed_recency=True)),
}
# The one-rank cases' batch sizes; their ids and negatives lie in [0, 32),
# the first data rank's rows of the 64 at P = 2 and 4.
ONE_RANK = {"tgn_one_rank": 16, "tgn_segment_one_rank": 1}
ONE_RANK_IDS = 32
CASES = tuple(TINY)
# The wiki-shaped cases (see below): (recency layout, pipeline options); each
# runs trained and ``_frozen``.
WIKI = {
    "tgn_eid_wiki": ("eid", {}),
    "tgn_segment_wiki": ("eid", dict(rowwise=False)),
    "tgn_packed_wiki": ("eid", dict(packed_state=True, packed_recency=True)),
    "tgn_attn_bf16_wiki": ("feature", dict(attn_bf16=True)),
}
WIKI_CASES = tuple(c for w in WIKI for c in (w, w + "_frozen"))
STEPS = 3
SHIFT = 1000  # seconds between the repeats of the batch
TOL = 1e-5
# The bf16 cases: bf16 roundings turn the ulps by which the sharded sums
# differ into whole bf16 steps, so their losses are held to BF16_LOSS_TOL
# and their float state to BF16_STATE_RTOL * max |x| of the single process
# (ROADMAP fault 2's band); integer state stays exact.
BF16_LOSS_TOL = 1e-4
BF16_STATE_RTOL = 5e-3
# The wiki-shaped cases: chip_smoke.py's TGNPipeline at the tgbl-wiki shape
# (9,227 nodes, 157,474 edges, 172-dim features, dims 100, K = 10, batches
# of 200), over WIKI_STEPS consecutive batches of a uniform chronological
# stream drawn from the seed, the feature table random; each trains with
# Adam at 1e-4 and, ``_frozen``, at lr = 0.
WIKI_NODES, WIKI_EDGES, WIKI_EDGE_DIM, WIKI_DIMS, WIKI_NBRS, WIKI_BATCH = (
    9_227, 157_474, 172, 100, 10, 200)
WIKI_STEPS = 10
# After the first step the two runs' weights are ulps apart (the gradients
# are summed in another order), and Time2Vec at gaps of 1e5 s turns that
# into other memory rows. So a trained wiki case holds the first step to
# TOL (BF16_LOSS_TOL), the later losses to the card's train-agree band and
# the integer state exact. The frozen cases keep the weights equal in both
# runs, so the paths that cross ranks (staging reads of the counterparts'
# memory, the store's counterpart ids) are held to the tiny cases' bounds
# over every step.
WIKI_LOSS_TOL = 5e-3


def case_spec(case: str):
    """(model, recency layout, pipeline options) of a case."""
    if case in TINY:
        return TINY[case]
    return ("tgn",) + WIKI[case.removesuffix("_frozen")]


def step_launches(case: str) -> dict:
    """Kernel launches a step on every rank, as on one device: TGN one query
    (K1 fused; K1's pre-gathered entry with packed recency; K4 in the
    feature layout), the push twice (none with packed recency, a PyTorch
    row write) and the store commit once (none on the packed state, PyTorch
    scatters); TGAT one query a hop and the push twice."""
    model, layout, opts = case_spec(case)
    if model == "tgat":
        select = "recency_feats_select" if layout == "feature" else "recency_eid_select"
        return {select: 2, "recency_push": 2}
    packed_rec = layout == "eid" and opts.get("packed_recency", False)
    select = ("recency_window_select_eid" if packed_rec else
              "recency_eid_select" if layout == "eid" else "recency_feats_select")
    out = {select: 1}
    if not packed_rec:
        out["recency_push"] = 2
    if not opts.get("packed_state", False):
        out["tgn_store_commit"] = 1
    return out


def tiny_tgn(eid_mode: bool, device, num_nodes=64, num_edges=256, edge_dim=16, batch_size=16,
             seed=0, id_high=None, **opts):
    """``__graft_entry__._tiny_setup``'s pipeline (with the ``TGNPipeline``
    options ``opts``) and batch in the port; ``id_high`` bounds the batch's
    ids and the negatives (default ``num_nodes``)."""
    id_high = num_nodes if id_high is None else id_high
    import torch

    from tgm_tpu_torch.core.batch import DGBatch
    from tgm_tpu_torch.train import TGNPipeline

    rng = np.random.default_rng(seed)
    edge_x_full = rng.normal(size=(num_edges, edge_dim)).astype(np.float32) if eid_mode else None
    pipe = TGNPipeline(num_nodes=num_nodes, edge_dim=edge_dim, memory_dim=32, embed_dim=32,
                       time_dim=16, num_nbrs=4, neg_low=0, neg_high=id_high,
                       edge_x_full=edge_x_full, device=device, **opts)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)
    batch = DGBatch(
        edge_src=i32(rng.integers(0, id_high, batch_size)),
        edge_dst=i32(rng.integers(0, id_high, batch_size)),
        edge_time=i32(np.sort(rng.integers(0, 1000, batch_size))),
        edge_valid=torch.ones(batch_size, dtype=torch.bool, device=device),
        edge_x=torch.as_tensor(rng.normal(size=(batch_size, edge_dim)).astype(np.float32),
                               device=device),
    )
    if eid_mode:
        batch.edge_ids = i32(rng.choice(num_edges, size=batch_size, replace=False))
    return pipe, batch


def tiny_tgat(device, layout="eid", batch_size=16, **opts):
    """``tests/test_parallel.py::_tiny_tgat``'s pipeline (with the
    ``TGATPipeline`` options ``opts``) and batch in the port
    (``layout="eid"``); ``"feature"``: the batch's edge features by value
    (K4); ``"aug"``: the side-augmented table over random endpoints."""
    import torch

    from tgm_tpu_torch.core.batch import DGBatch
    from tgm_tpu_torch.train import TGATPipeline

    rng = np.random.default_rng(0)
    N, D, E = 32, 4, 256
    node_x = rng.normal(size=(N, 3)).astype(np.float32)
    edge_x_full = rng.normal(size=(E, D)).astype(np.float32)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)
    B = batch_size
    batch = DGBatch(edge_src=i32(rng.integers(0, N, B)), edge_dst=i32(rng.integers(0, N, B)),
                    edge_time=i32(np.sort(rng.integers(1, 100, B))),
                    edge_valid=torch.ones(B, dtype=torch.bool, device=device))
    batch.edge_ids = torch.arange(B, dtype=torch.int32, device=device)
    ends = None
    if layout == "feature":
        batch.edge_x = torch.as_tensor(edge_x_full[:B], device=device)
    elif layout == "aug":
        ends = (rng.integers(0, N, E), rng.integers(0, N, E))
        ends[0][:B], ends[1][:B] = batch.edge_src.cpu().numpy(), batch.edge_dst.cpu().numpy()
    pipe = TGATPipeline(num_nodes=N, edge_dim=D, node_x=node_x, num_nbrs=(4, 4), time_dim=8,
                        embed_dim=16, n_heads=2, lr=1e-3, neg_low=0, neg_high=N,
                        edge_x_full=None if layout == "feature" else edge_x_full,
                        edge_ends_full=ends, device=device, **opts)
    return pipe, batch


@functools.lru_cache(maxsize=1)
def wiki_draws(seed: int):
    """The wiki cases' random feature table and stream (src, dst, t) of
    WIKI_STEPS batches, drawn once a process (every wiki case shares them)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(WIKI_EDGES, WIKI_EDGE_DIM)).astype(np.float32)
    n = WIKI_STEPS * WIKI_BATCH
    src, dst = rng.integers(0, WIKI_NODES, n), rng.integers(0, WIKI_NODES, n)
    return table, src, dst, np.sort(rng.integers(0, 100 * n, n))


def wiki_tgn(device, lr=1e-4, seed=0, layout="eid", **opts):
    """The wiki-shaped pipeline (Adam at ``lr``; the eid or the feature
    recency layout; the ``TGNPipeline`` options ``opts``) and its WIKI_STEPS
    batches."""
    import torch

    from tgm_tpu_torch.core.batch import DGBatch
    from tgm_tpu_torch.train import TGNPipeline

    table, src, dst, t = wiki_draws(seed)
    table = torch.tensor(table, device=device)
    pipe = TGNPipeline(WIKI_NODES, WIKI_EDGE_DIM, WIKI_DIMS, WIKI_DIMS, WIKI_DIMS, WIKI_NBRS,
                       lr, 0, WIKI_NODES, edge_x_full=table if layout == "eid" else None,
                       device=device, **opts)
    n = WIKI_STEPS * WIKI_BATCH
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)
    src, dst, t = i32(src), i32(dst), i32(t)
    eids = torch.arange(n, dtype=torch.int32, device=device)
    batches = []
    for i in range(WIKI_STEPS):
        sl = slice(i * WIKI_BATCH, (i + 1) * WIKI_BATCH)
        batches.append(DGBatch(src[sl], dst[sl], t[sl],
                               torch.ones(WIKI_BATCH, dtype=torch.bool, device=device),
                               edge_ids=eids[sl], edge_x=table[eids[sl].long()]))
    return pipe, batches


def build(case: str, device, inputs):
    """``(pipe, batches, carry)`` of a case: the batches of its steps (the
    tiny cases' one batch, each repeat ``SHIFT`` s later: ROADMAP fault 1
    otherwise), and the weights and negatives of ``inputs[case]`` where
    given."""
    import torch

    model, layout, opts = case_spec(case)
    if case in WIKI_CASES:
        pipe, batches = wiki_tgn(device, lr=0.0 if case.endswith("frozen") else 1e-4,
                                 layout=layout, **opts)
    else:
        if model == "tgat":
            pipe, batch = tiny_tgat(device, layout, **opts)
        elif case in ONE_RANK:
            pipe, batch = tiny_tgn(layout == "eid", device, batch_size=ONE_RANK[case],
                                   id_high=ONE_RANK_IDS, **opts)
        else:
            pipe, batch = tiny_tgn(layout == "eid", device, **opts)
        batches = [batch.replace(edge_time=batch.edge_time + i * SHIFT) for i in range(STEPS)]
    given = (inputs or {}).get(case)
    if given is not None:
        negs = iter(given["negs"])
        pipe.draw_neg = lambda rng, size: torch.as_tensor(next(negs), dtype=torch.int32,
                                                          device=rng.device)
    carry = pipe.init_carry(0, params=None if given is None else given["params"])
    return pipe, batches, carry


def state_arrays(carry) -> dict:
    """numpy copies of a carry's state (the steps update it in place)."""
    out = {f"rec{i}": x.detach().cpu().numpy().copy() for i, x in enumerate(carry.rec_state)}
    if hasattr(carry, "mem_state"):
        out.update({f"mem.{k}": v.detach().cpu().numpy().copy()
                    for k, v in carry.mem_state._asdict().items()})
    return out


def max_gap(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
               for k in a)


def max_rel_gap(a: dict, b: dict) -> float:
    """The largest gap of a float field over the field's largest |value| in
    ``b`` (0 without float fields)."""
    gaps = [float(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64)).max())
            / max(float(np.abs(b[k]).max()), 1e-30) for k in a if b[k].dtype.kind == "f"]
    return max(gaps, default=0.0)


def kernel_wrappers():
    from tgm_tpu_torch.ops.recency_select import (
        recency_eid_select,
        recency_feats_select,
        recency_window_select_eid,
    )
    from tgm_tpu_torch.ops.scatter_cells import recency_push, tgn_store_commit

    return (recency_eid_select, recency_window_select_eid, recency_feats_select, recency_push,
            tgn_store_commit)


def timed_steps(step, carry, batches, device):
    """Run ``step`` over ``batches``: (carry, losses, ms a step, launches)."""
    import torch

    for f in kernel_wrappers():
        f.launches = 0
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    losses, t0 = [], time.perf_counter()
    for b in batches:
        carry, loss = step(carry, b)
        losses.append(loss)
    sync()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    return carry, [float(x) for x in losses], ms, {f.__name__: f.launches
                                                   for f in kernel_wrappers()}


def worker(rank: int, world: int, pg_file: str, device_name: str, cases, inputs_path,
           dump_path, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    from tgm_tpu_torch.parallel import (
        batch_shardings,
        data_model_mesh,
        gather,
        initialize_distributed,
        make_mesh,
        place,
        sharded_tgat_train_step,
        sharded_tgn_train_step,
        tgat_carry_shardings,
        tgat_carry_shardings_2d,
        tgn_carry_shardings,
        tgn_carry_shardings_2d,
    )
    from tgm_tpu_torch.parallel.mesh import MeshAxis

    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(0)  # every rank shares the one card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    backend = "nccl" if device.type == "cuda" and world == 1 else "gloo"
    initialize_distributed(backend=backend, init_method=f"file://{pg_file}", world_size=world,
                           rank=rank)
    two_d = world == 4
    mesh = (data_model_mesh(2, 2, device_type=device.type) if two_d
            else make_mesh(device_type=device.type))
    data = MeshAxis(mesh, "data")

    def answers(case):
        """Whether this rank owns a requested row, and so launches the query:
        every rank, but in a ONE_RANK case only the first data rank and, where
        some slice is padded (its PAD seeds are the last rank's), the last."""
        if case not in ONE_RANK:
            return True
        padded = ONE_RANK[case] % data.size != 0
        return data.index == 0 or (padded and data.index == data.size - 1)
    inputs = None
    if inputs_path:
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)

    rec = {"num_processes": world, "backend": backend, "device": device_name,
           "mesh_shape": list(mesh.mesh.shape), "mesh_axes": list(mesh.mesh_dim_names),
           "cases": {}}
    dump = {}
    for case in cases:
        pipe, batches, carry = build(case, device, inputs)
        if case.startswith("tgat"):
            layout = (tgat_carry_shardings_2d if two_d else tgat_carry_shardings)(mesh, carry)
            step = sharded_tgat_train_step(pipe, mesh)
        else:
            layout = (tgn_carry_shardings_2d if two_d else tgn_carry_shardings)(mesh, carry)
            step = sharded_tgn_train_step(pipe, mesh)
        split = sum(bool(s.spec) for s in layout.params.values())
        sharded = place(carry, layout)
        local = [place(b, batch_shardings(mesh, b)) for b in batches]
        # The first step alone (its state gathered), then the rest timed.
        sharded, first, _, _ = timed_steps(step, sharded, local[:1], device)
        state1 = state_arrays(gather(sharded, layout))
        sharded, losses, ms, launches = timed_steps(step, sharded, local[1:], device)
        need = {k: v * (len(batches) - 1) for k, v in step_launches(case).items()
                if "select" not in k or answers(case)}
        if device.type == "cuda" and launches != dict(dict.fromkeys(launches, 0), **need):
            raise AssertionError(f"rank {rank} {case}: launches {launches}, expected {need}")
        losses = first + losses
        whole = gather(sharded, layout)
        state = state_arrays(whole)
        # The carry's modules hold the whole weights after every step.
        params_whole = all(torch.equal(p, q) for p, q in zip(sharded.params.parameters(),
                                                              whole.params.parameters()))
        if rank != 0:
            continue
        pipe1, batches1, carry1 = build(case, device, inputs)
        carry1, ref, _, _ = timed_steps(pipe1.train_step, carry1, batches1[:1], device)
        ref_state1 = state_arrays(carry1)
        carry1, ref_rest, ref_ms, _ = timed_steps(pipe1.train_step, carry1, batches1[1:], device)
        ref = ref + ref_rest
        ref_state = state_arrays(carry1)
        gaps = [abs(a - b) for a, b in zip(losses, ref)]
        bf16 = "bf16" in case
        loss_tol = BF16_LOSS_TOL if bf16 else TOL
        state_ok = ((lambda a, b: max_rel_gap(a, b) <= BF16_STATE_RTOL) if bf16
                    else (lambda a, b: max_gap(a, b) <= TOL))
        c = rec["cases"][case] = {
            "steps": len(batches), "losses": losses, "losses_single_process": ref,
            "ms_per_step": ms, "ms_per_step_single_process": ref_ms, "launches_rank0": launches,
            "split_params": split, "max_abs_diff_loss": max(gaps),
            "max_abs_diff_state_step1": max_gap(state1, ref_state1),
            "max_abs_diff_state": max_gap(state, ref_state),
            "int_state_equal": all(np.array_equal(state[k], ref_state[k]) for k in state
                                   if state[k].dtype.kind != "f"),
            "params_whole": params_whole,
        }
        if bf16:
            c["max_rel_diff_float_state_step1"] = max_rel_gap(state1, ref_state1)
            c["max_rel_diff_float_state"] = max_rel_gap(state, ref_state)
        if case in WIKI:  # trained
            c["ok"] = (gaps[0] <= loss_tol and state_ok(state1, ref_state1)
                       and max(gaps) <= WIKI_LOSS_TOL)
        else:
            c["ok"] = max(gaps) <= loss_tol and state_ok(state, ref_state)
        c["ok"] = bool(c["ok"] and c["int_state_equal"] and params_whole)
        dump[case] = {"losses": losses, "state": state, "replay_losses": ref,
                      "replay_state": ref_state}
    if rank == 0:
        rec["ok"] = all(c["ok"] for c in rec["cases"].values())
        if dump_path:
            with open(dump_path, "wb") as f:
                pickle.dump(dump, f)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="torch_multihost_sim.json")
    p.add_argument("--cases", nargs="+", default=list(CASES),
                   choices=list(CASES + WIKI_CASES))
    p.add_argument("--inputs", default=None)
    p.add_argument("--dump", default=None)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--pg-file", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.num_processes not in (1, 2, 4):
        raise SystemExit("--num-processes must be 1, 2 (1-D mesh) or 4 (2 x 2 mesh)")

    if args.rank is not None:
        worker(args.rank, args.num_processes, args.pg_file, args.device, args.cases,
               args.inputs, args.dump, args.out)
        return 0

    with tempfile.TemporaryDirectory() as tmp:
        pg_file = os.path.join(tmp, "pg")
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--num-processes",
             str(args.num_processes), "--pg-file", pg_file, "--device", args.device,
             "--out", args.out, "--cases", *args.cases]
            + (["--inputs", args.inputs] if args.inputs else [])
            + (["--dump", args.dump] if args.dump else []), env=env)
            for r in range(args.num_processes)]
        try:
            codes = [q.wait(timeout=600) for q in procs]
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
    if any(codes):
        print(f"worker exit codes: {codes}", file=sys.stderr)
        return 1
    with open(args.out) as f:
        rec = json.load(f)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
