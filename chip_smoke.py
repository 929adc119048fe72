#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed 0]

Drives the port's serving path (TGN streaming link-prediction inference
through the hook API) and its three hand-written CUDA kernels, in phases:

1. build:   compile ``tgm_tpu_torch/csrc/*.cu`` with nvcc (all at once).
2. kernels: each kernel at the serving shapes against its plain PyTorch
            version on the card (exact integer equality), with its time, the
            plain version's, a single PyTorch call's where one computes the
            same thing, and the least time the card could take (bound).
3. serve:   a tgbl-wiki-shaped stream (9,227 nodes, 157,474 edges, 172-dim
            features) split 70/15/15, TGN (dims 100, 2 heads, K = 10,
            batch 200, seeded random weights), val then test through
            ``hook_epoch``; MRR, edges/s and each kernel's launches.
4. agree:   the first 3 val batches on the card (kernels) and on the CPU
            (plain versions) with the same weights and candidates: integer
            state exact, memory within atol 1e-4, per-batch MRR sums within 1e-4.

It exits non-zero without a CUDA device. The last line is the device JSON
object; the line before it the kernels JSON object, and the one before that
the card's name and power limit from nvidia-smi. TF32 is off: fp32 matmuls
run in full fp32.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

# tgbl-wiki shape (the repo's bench stream).
WIKI_NODES = 9_227
WIKI_EDGES = 157_474
WIKI_EDGE_DIM = 172
DIMS = 100
NUM_NBRS = 10
BATCH = 200
NUM_CANDIDATES = 20
AGREE_BATCHES = 3
TIMING_ITERS = 200  # calls per kernel timing

# Published H100 SXM rates (NVIDIA data sheet, at the 700 W limit): HBM3
# bytes/s, and the fp32 rate outside the tensor cores, taken as the rate of
# the kernels' scalar integer work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

K1_SRC = "tgm_tpu_torch/csrc/recency_select.cu"
K23_SRC = "tgm_tpu_torch/csrc/scatter_cells.cu"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _events_us(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1000.0 / iters


def cuda_time_us(fn, iters: int):
    """(device_us, eager_us) per call of ``fn``, both from CUDA events.

    device_us replays ``iters`` calls captured in one CUDA graph, so the host
    never holds the card back: the time of the work on the card. eager_us
    times ``iters`` calls issued from Python, wrapper overhead included: what
    a call costs the serving loop.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def eager():
        for _ in range(iters):
            fn()

    eager_us = _events_us(eager, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device_us = _events_us(graph.replay, iters)
    return device_us, eager_us


def bound_us(nbytes: float, ops: float):
    """Least time for the work: bytes over HBM rate or operations over peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = ops / SCALAR_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
# Kernel inputs at the serving shapes
# ---------------------------------------------------------------------- #
def k1_inputs(rng, S: int, B: int, dev):
    """Pre-gathered ring rows as a chronological stream's pushes leave them:
    times non-decreasing in push order with ties, PAD slots in rows pushed
    fewer than B times, empty rows (wp = 0), invalid seeds (the dump row)."""
    ids = np.full((S, B), -1, np.int32)
    times = np.zeros((S, B), np.int32)
    eids = np.full((S, B), -1, np.int32)
    count = rng.integers(0, 3 * B, S)
    count[rng.random(S) < 0.05] = 0  # empty rows
    steps = rng.integers(0, 3, (S, 3 * B))  # zero steps give time ties
    ev_t = 1000 + np.cumsum(steps, axis=1)
    for e in range(3 * B):
        live = e < count
        ids[live, e % B] = rng.integers(0, WIKI_NODES, live.sum())
        times[live, e % B] = ev_t[live, e]
        eids[live, e % B] = rng.integers(0, WIKI_EDGES, live.sum())
    last_t = np.where(count > 0, ev_t[np.arange(S), np.maximum(count - 1, 0)], 1000)
    qt = (last_t + rng.integers(-4, 3, S)).astype(np.int32)  # some newest slots excluded
    wp = count.astype(np.int32)
    invalid = rng.random(S) < 0.03  # invalid seeds read the pristine dump row
    ids[invalid], times[invalid], eids[invalid], wp[invalid] = -1, 0, -1, 0
    up = lambda x: torch.as_tensor(x, device=dev)
    return up(ids), up(times), up(eids), up(wp), up(qt)


def k2_inputs(rng, dev):
    """One recency push at serving shape: the dense plan of 200 undirected
    edges (10 of them padding) into (9228, 10) buffers."""
    from tgm_tpu_torch.hooks.neighbors import _push_plan_dense

    N1 = WIKI_NODES + 1
    wp = torch.as_tensor(rng.integers(0, 50, N1).astype(np.int32), device=dev)
    src = torch.as_tensor(rng.integers(0, WIKI_NODES, BATCH).astype(np.int32), device=dev)
    dst = torch.as_tensor(rng.integers(0, WIKI_NODES, BATCH).astype(np.int32), device=dev)
    t = torch.as_tensor(np.sort(rng.integers(0, 3000, BATCH)).astype(np.int32), device=dev)
    valid = torch.arange(BATCH, device=dev) < BATCH - 10
    rows, cols, nbrs, _, _, _ = _push_plan_dense(NUM_NBRS, wp, src, dst, t, valid, False,
                                                 WIKI_NODES)
    buf = torch.as_tensor(rng.integers(-1, WIKI_NODES, (N1, NUM_NBRS)).astype(np.int32),
                          device=dev)
    return buf, rows, cols, nbrs


def k3_inputs(rng, dev):
    """One message store at serving shape: per role, 200 winner rows (unique
    live rows, non-winners aimed at the dump row) into four (9228,) stores."""
    N1 = WIKI_NODES + 1

    def role():
        rows = rng.choice(WIKI_NODES, BATCH, replace=False).astype(np.int32)
        rows[rng.random(BATCH) < 0.3] = WIKI_NODES
        return (torch.as_tensor(rows, device=dev),
                torch.as_tensor(rng.integers(0, WIKI_NODES, BATCH).astype(np.int32), device=dev),
                torch.as_tensor(rng.integers(0, 10**6, BATCH).astype(np.int32), device=dev))

    stores = [torch.as_tensor(rng.integers(-1, 10**6, N1).astype(np.int32), device=dev)
              for _ in range(4)]
    return stores, role(), role()


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _time_and_report(label, run_kernel, run_plain, run_library, nbytes, ops, err, card):
    """Time kernel, plain version and library call; log one line; return the JSON entry."""
    k_dev, k_call = cuda_time_us(run_kernel, TIMING_ITERS)
    p_dev, p_call = cuda_time_us(run_plain, TIMING_ITERS)
    l_dev, l_call = cuda_time_us(run_library, TIMING_ITERS) if run_library else (None, None)
    b_us, b_by = bound_us(nbytes, ops)
    lib = "none" if l_dev is None else f"{l_dev:.2f}"
    log("kernels", f"{label}: exact (max_abs_err {err}) kernel_us={k_dev:.2f} "
                   f"plain_us={p_dev:.2f} library_us={lib} bound_us={b_us:.4f} ({b_by}); "
                   f"per call from Python: kernel {k_call:.2f} plain {p_call:.2f} "
                   f"library {'none' if l_call is None else f'{l_call:.2f}'} us [{card}]")
    return dict(ms=k_dev / 1e3, plain_ms=p_dev / 1e3, bound_ms=b_us / 1e3, bound_by=b_by,
                library_ms=None if l_dev is None else l_dev / 1e3, max_abs_err=err)


def kernel_phase(rng, dev, card: str):
    """Each kernel at the serving shapes: exact against its plain version, timed.

    Times are device times (``TIMING_ITERS`` calls replayed from one CUDA graph),
    with the per-call time from Python beside them. The bound counts each
    input read once and each output written once.
    """
    from tgm_tpu_torch.ops.recency_select import (
        recency_window_select_eid,
        recency_window_select_eid_plain,
    )
    from tgm_tpu_torch.ops.scatter_cells import (
        scatter_cells,
        scatter_cells_plain,
        tgn_store_scatter_1d,
        tgn_store_scatter_1d_plain,
    )

    report = {}
    B = K = NUM_NBRS
    # K1 at the train (600) and eval (4,400) seed counts; the serving path
    # runs the eval count, whose entry is the one reported.
    for S in (600, 2 * BATCH + BATCH * NUM_CANDIDATES):
        args = k1_inputs(rng, S, B, dev)
        got = recency_window_select_eid(*args, K)
        want = recency_window_select_eid_plain(*args, K)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err:
            raise AssertionError(f"K1 differs from its plain version at S={S}: {err}")
        filled = int((got[0] != -1).sum())
        report["recency_window_select_eid"] = _time_and_report(
            f"K1 recency_window_select_eid S={S} B={B} K={K} (filled {filled}/{S * K})",
            lambda: recency_window_select_eid(*args, K),
            lambda: recency_window_select_eid_plain(*args, K),
            None, 4 * (3 * S * B + 2 * S + 3 * S * K), 6 * S * B, err, card)

    # K2 on one push's cells.
    buf, rows, cols, vals = k2_inputs(rng, dev)
    got = scatter_cells(buf.clone(), rows, cols, vals)
    want = scatter_cells_plain(buf.clone(), rows, cols, vals)
    torch.cuda.synchronize()
    err = _max_abs_err([got], [want])
    if err:
        raise AssertionError(f"K2 differs from its plain version: {err}")
    E = rows.shape[0]
    live = int(((rows >= 0) & (rows <= buf.shape[0] - 2)).sum())
    work = buf.clone()
    rl, cl = rows.long(), cols.long()
    report["scatter_cells"] = _time_and_report(
        f"K2 scatter_cells buf={tuple(buf.shape)} E={E} live={live}",
        lambda: scatter_cells(work, rows, cols, vals),
        lambda: scatter_cells_plain(work, rows, cols, vals),
        lambda: work.index_put_((rl, cl), vals),  # library yardstick (no dump-row skip)
        4 * (3 * E + live), 4 * E, err, card)

    # K3 on one message store. No single PyTorch call does the four stores.
    stores, (rs, vso, vst), (rd, vdo, vdt) = k3_inputs(rng, dev)
    last_live = WIKI_NODES - 1
    a = [s.clone() for s in stores]
    b = [s.clone() for s in stores]
    tgn_store_scatter_1d(*a, rs, vso, vst, rd, vdo, vdt, last_live_row=last_live)
    tgn_store_scatter_1d_plain(*b, rs, vso, vst, rd, vdo, vdt, last_live)
    torch.cuda.synchronize()
    err = _max_abs_err(a, b)
    if err:
        raise AssertionError(f"K3 differs from its plain version: {err}")
    live = int((rs <= last_live).sum() + (rd <= last_live).sum())
    report["tgn_store_scatter_1d"] = _time_and_report(
        f"K3 tgn_store_scatter_1d stores=4x({stores[0].shape[0]},) E={BATCH} per role live={live}",
        lambda: tgn_store_scatter_1d(*a, rs, vso, vst, rd, vdo, vdt, last_live_row=last_live),
        lambda: tgn_store_scatter_1d_plain(*a, rs, vso, vst, rd, vdo, vdt, last_live),
        None, 4 * (6 * BATCH + 2 * live), 4 * BATCH, err, card)
    return report


# ---------------------------------------------------------------------- #
# The serving path
# ---------------------------------------------------------------------- #
def build_stream(seed: int):
    """tgbl-wiki-shaped synthetic stream plus 20 TGB-style candidates per
    val/test edge, from one numpy generator (the repo's bench recipe)."""
    from tgm_tpu_torch import DGData

    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.4, size=WIKI_NODES).astype(np.float64)
    pop /= pop.sum()
    src = rng.choice(WIKI_NODES, size=WIKI_EDGES, p=pop)
    dst = rng.choice(WIKI_NODES, size=WIKI_EDGES, p=pop)
    dst = np.where(dst == src, (dst + 1) % WIKI_NODES, dst)
    t = np.sort(rng.integers(0, 2_678_373, size=WIKI_EDGES))
    edge_x = rng.normal(size=(WIKI_EDGES, WIKI_EDGE_DIM)).astype(np.float32)
    data = DGData.from_raw(t, np.stack([src, dst], 1).astype(np.int32), edge_x, time_delta="s")
    _, val, test = data.split()
    cands = {name: rng.choice(WIKI_NODES, size=(d.num_edge_events, NUM_CANDIDATES), p=pop)
             for name, d in (("val", val), ("test", test))}
    return data, val, test, cands


def make_models(seed: int):
    from tgm_tpu_torch.nn import GraphAttentionEmbeddingRowwise, LinkPredictor, TGNMemory

    torch.manual_seed(seed)
    memory = TGNMemory(WIKI_NODES, WIKI_EDGE_DIM, DIMS, DIMS)
    encoder = GraphAttentionEmbeddingRowwise(DIMS, DIMS, WIKI_EDGE_DIM, DIMS, n_heads=2,
                                             dropout=0.1)
    decoder = LinkPredictor(node_dim=DIMS, hidden_dim=DIMS)
    return [m.eval() for m in (memory, encoder, decoder)]


def make_pipeline(data, cands, models, device):
    from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TGBNegativeEdgeSamplerHook
    from tgm_tpu_torch.train import build_tgn_hook_cores

    memory, encoder, decoder = (m.to(device) for m in models)
    hm = HookManager(keys=["val", "test"])
    for split in ("val", "test"):
        hm.register(split, TGBNegativeEdgeSamplerHook(cands[split], device=device))
    rec = RecencyNeighborHook(
        WIKI_NODES, [NUM_NBRS], ["edge_src", "edge_dst", "neg"],
        ["edge_time", "edge_time", "neg_time"], edge_dim=WIKI_EDGE_DIM,
        edge_x_full=data.edge_x, device=device,
    )
    hm.register_shared(rec)
    eval_core = build_tgn_hook_cores(memory, encoder, decoder, WIKI_NODES)
    return hm, rec, memory, eval_core


def kernel_wrappers():
    """The wrappers of the serving path's kernels; each counts its launches."""
    from tgm_tpu_torch.ops.recency_select import recency_window_select_eid
    from tgm_tpu_torch.ops.scatter_cells import scatter_cells, tgn_store_scatter_1d

    return recency_window_select_eid, scatter_cells, tgn_store_scatter_1d


def serve_phase(data, val, test, cands, models, dev, card):
    from tgm_tpu_torch import DGraph
    from tgm_tpu_torch.train import DeviceEdgeStream, hook_epoch

    hm, _, memory, eval_core = make_pipeline(data, cands, models, dev)
    mem_state = memory.init_state(dev)
    n_batches, n_edges, seconds, mrr = 0, 0, 0.0, {}
    for f in kernel_wrappers():
        f.launches = 0
    for split, d in (("val", val), ("test", test)):
        dg = DGraph(d)
        stream = DeviceEdgeStream(dg, BATCH, device=dev)
        epoch, states = hook_epoch(stream, hm, split, dg, eval_core)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mem_state, states, (s, c) = epoch(mem_state, states)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hm.adopt_states(split, states)
        mrr[split] = float(s.sum() / c.sum())
        n_batches += stream.num_batches
        n_edges += stream.num_edges
        seconds += dt
        log("serve", f"{split}: {stream.num_edges} edges in {stream.num_batches} batches, "
                     f"{dt:.3f} s, {stream.num_edges / dt:.0f} edges/s, MRR {mrr[split]:.4f} [{card}]")
    launches = {f.__name__: f.launches for f in kernel_wrappers()}
    for name, need in (("recency_window_select_eid", 1), ("scatter_cells", 3),
                       ("tgn_store_scatter_1d", 1)):
        if launches[name] < need * n_batches:
            raise AssertionError(f"{name}: {launches[name]} launches for {n_batches} batches")
    if not all(np.isfinite(v) and 0.0 < v <= 1.0 for v in mrr.values()):
        raise AssertionError(f"MRR out of range: {mrr}")
    if not torch.isfinite(mem_state.mem).all():
        raise AssertionError("non-finite memory after serving")
    log("serve", f"val_mrr={mrr['val']:.6f} test_mrr={mrr['test']:.6f} "
                 f"serve_edges_per_s={n_edges / seconds:.0f} batches={n_batches} "
                 f"launches={launches} per_batch="
                 f"{ {k: v / n_batches for k, v in launches.items()} } [{card}]")
    return launches


def agree_phase(data, val, cands, models, dev, card):
    from tgm_tpu_torch import DGraph
    from tgm_tpu_torch.train import DeviceEdgeStream

    cpu_models = [copy.deepcopy(m).to("cpu") for m in models]
    runs = {}
    for device, mods in ((dev, models), (torch.device("cpu"), cpu_models)):
        hm, rec, memory, eval_core = make_pipeline(data, cands, mods, device)
        dg = DGraph(val)
        stream = DeviceEdgeStream(dg, BATCH, device=device)
        fn, states = hm.as_transform("val", dg)
        mem_state = memory.init_state(device)
        sums = []
        for i in range(AGREE_BATCHES):
            states, batch = fn(states, stream.batch_at(i))
            mem_state, (s, _) = eval_core(mem_state, batch)
            sums.append(float(s))
        # The recency buffers are updated in place: the hook's state is the final one.
        runs[device.type] = (rec.state, mem_state, sums)
    (g_rec, g_mem, g_sums), (c_rec, c_mem, c_sums) = runs["cuda"], runs["cpu"]
    for name, g, c in zip(("nbr_ids", "nbr_times", "nbr_eids", "write_pos"), g_rec, c_rec):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"recency {name} differs between card and CPU")
    for name in ("last_update", "s_other", "s_t", "s_valid", "d_other", "d_t", "d_valid"):
        if not torch.equal(getattr(g_mem, name).cpu(), getattr(c_mem, name)):
            raise AssertionError(f"memory state {name} differs between card and CPU")
    mem_err = float((g_mem.mem.cpu() - c_mem.mem).abs().max())
    raw_err = max(float((getattr(g_mem, n).cpu() - getattr(c_mem, n)).abs().max())
                  for n in ("s_raw", "d_raw"))
    mrr_err = max(abs(a - b) for a, b in zip(g_sums, c_sums))
    if not (mem_err <= 1e-4 and raw_err <= 1e-4 and mrr_err <= 1e-4):
        raise AssertionError(f"card vs CPU: mem {mem_err} raw {raw_err} mrr sums {mrr_err}")
    log("agree", f"{AGREE_BATCHES} val batches: integer state exact, max |mem| diff {mem_err:.3g}, "
                 f"max |raw| diff {raw_err:.3g}, max per-batch MRR-sum diff {mrr_err:.3g} "
                 f"(card {g_sums}, CPU {c_sums}) [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke test needs a card",
              file=sys.stderr)
        return 1
    # The port runs fp32 end to end: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tgm_tpu_torch.ops import _native

    dev = torch.device("cuda")
    card = nvidia_smi()
    t0 = time.perf_counter()
    _native.build_all()
    nvcc_release = subprocess.run([_native._nvcc(), "--version"], capture_output=True, text=True,
                                  check=True, timeout=60).stdout.strip().splitlines()[-1]
    log("build", f"{time.perf_counter() - t0:.1f} s (nvcc {_native.build_seconds:.1f} s) "
                 f"torch {torch.__version__} cuda {torch.version.cuda} python "
                 f"{sys.version.split()[0]}; {nvcc_release} [{card}]")

    rng = np.random.default_rng(args.seed)
    report = kernel_phase(rng, dev, card)

    t0 = time.perf_counter()
    data, val, test, cands = build_stream(args.seed)
    models = make_models(args.seed)
    log("serve", f"stream {WIKI_NODES} nodes, {WIKI_EDGES} edges, edge dim {WIKI_EDGE_DIM}, "
                 f"val {val.num_edge_events} / test {test.num_edge_events} edges, "
                 f"built in {time.perf_counter() - t0:.1f} s")
    launches = serve_phase(data, val, test, cands, models, dev, card)
    agree_phase(data, val, cands, models, dev, card)

    sources = {"recency_window_select_eid": (K1_SRC, "tgm_tpu/ops/pallas/recency_select.py:208"),
               "scatter_cells": (K23_SRC, "tgm_tpu/ops/pallas/scatter_cells.py:53"),
               "tgn_store_scatter_1d": (K23_SRC, "tgm_tpu/ops/pallas/scatter_cells.py:111")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], **report[name]}
               for name, (src, replaces) in sources.items()]
    kernels[0]["also_replaces"] = "tgm_tpu/ops/pallas/recency_select.py:156"
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
