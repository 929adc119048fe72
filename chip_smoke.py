#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed 0]

Drives the port's two serving paths through the hook API, TGN and
DyGFormer streaming link-prediction inference, and its five hand-written
CUDA kernels, in phases:

1. build:     compile ``tgm_tpu_torch/csrc/*.cu`` with nvcc (all at once).
2. kernels:   each kernel at the serving shapes against its plain PyTorch
              version on the card (K1-K4 exact; K5 within 5e-3 * max |plain|),
              with its time, the plain version's, a single PyTorch call's
              where one computes the same thing, and the least time the card
              could take (bound); for K5 also the device time of each of its
              five kernels per layer and their CTAs per SM.
3. serve:     a tgbl-wiki-shaped stream (9,227 nodes, 157,474 edges, 172-dim
              features) split 70/15/15, TGN (dims 100, 2 heads, K = 10,
              batch 200, seeded random weights), val then test through
              ``hook_epoch``; MRR, edges/s and each kernel's launches.
4. agree:     the first 3 val batches on the card (kernels) and on the CPU
              (plain versions) with the same weights and candidates: integer
              state exact, memory within atol 1e-4, per-batch MRR sums
              within 1e-4.
5. dyg-serve: the same stream through DyGFormer at the JAX package's full
              width (channel 50, so D = 200, time dim 100, sequences of 32
              per side, 2 layers, 2 heads, FFN 800, output 172, K = 20
              recency neighbours in the feature-buffer layout, batch 200, 20
              candidates, seeded random weights), val then test through
              ``hook_epoch``; MRR, edges/s, distinct nodes active in val and
              each kernel's launches.
6. dyg-agree: the first 2 val batches on the card and on the CPU with the
              same weights and candidates: recency state exact (the fp32
              feature buffer included), embeddings within 5e-3 * max |z|,
              per-batch MRR sums within 0.5.

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
# DyGFormer at the JAX package's full width (examples/linkproppred/dygformer.py).
DYG = dict(node_feat_dim=1, edge_x_dim=WIKI_EDGE_DIM, time_feat_dim=100,
           channel_embedding_dim=50, output_dim=172, patch_size=1, num_layers=2, num_heads=2,
           max_input_sequence_length=32)
DYG_NBRS = 20
DYG_AGREE_BATCHES = 2
K5_TIMING_ITERS = 10  # K5 runs for milliseconds: events around eager calls suffice
K5_TOL = 5e-3  # max |kernel - plain| <= K5_TOL * max |plain|

# Published H100 SXM rates (NVIDIA data sheet, at the 700 W limit): HBM3
# bytes/s, the fp32 rate outside the tensor cores, taken as the rate of the
# kernels' scalar integer work, and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

K14_SRC = "tgm_tpu_torch/csrc/recency_select.cu"
K23_SRC = "tgm_tpu_torch/csrc/scatter_cells.cu"
K5_SRC = "tgm_tpu_torch/csrc/dyg_transformer.cu"


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


def cuda_time_us(fn, iters: int, graph: bool = True):
    """(device_us, eager_us) per call of ``fn``, both from CUDA events.

    device_us replays ``iters`` calls captured in one CUDA graph, so the host
    never holds the card back: the time of the work on the card. eager_us
    times ``iters`` calls issued from Python, wrapper overhead included: what
    a call costs the serving loop. With ``graph=False`` (calls of
    milliseconds, where the host cannot hold the card back) device_us is
    eager_us.
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
    if not graph:
        return eager_us, eager_us
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    device_us = _events_us(g.replay, iters)
    return device_us, eager_us


def bound_us(nbytes: float, ops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    """Least time for the work: bytes over HBM rate or operations over peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = ops / ops_per_s * 1e6
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


def _time_and_report(label, run_kernel, run_plain, run_library, nbytes, ops, err, card,
                     iters=TIMING_ITERS, graph=True, ops_per_s=SCALAR_OPS_PER_S):
    """Time kernel, plain version and library call; log one line; return the JSON entry."""
    k_dev, k_call = cuda_time_us(run_kernel, iters, graph)
    p_dev, p_call = cuda_time_us(run_plain, iters, graph)
    l_dev, l_call = cuda_time_us(run_library, iters, graph) if run_library else (None, None)
    b_us, b_by = bound_us(nbytes, ops, ops_per_s)
    lib = "none" if l_dev is None else f"{l_dev:.2f}"
    agree = "exact" if err == 0 else "within tolerance"
    log("kernels", f"{label}: {agree} (max_abs_err {err}) kernel_us={k_dev:.2f} "
                   f"plain_us={p_dev:.2f} library_us={lib} bound_us={b_us:.4f} ({b_by}); "
                   f"per call from Python: kernel {k_call:.2f} plain {p_call:.2f} "
                   f"library {'none' if l_call is None else f'{l_call:.2f}'} us [{card}]")
    return dict(ms=k_dev / 1e3, plain_ms=p_dev / 1e3, bound_ms=b_us / 1e3, bound_by=b_by,
                library_ms=None if l_dev is None else l_dev / 1e3, max_abs_err=err)


def torch_transformer(layers, num_heads: int, dev):
    """``torch.nn.TransformerEncoder`` (pre-LN, exact gelu, eval) holding the
    same weights as the stack: the library yardstick for K5, timed here and
    used nowhere in the port."""
    D, F = layers[0]["w1"].shape
    layer = torch.nn.TransformerEncoderLayer(D, num_heads, F, dropout=0.0, activation="gelu",
                                             batch_first=True, norm_first=True)
    enc = torch.nn.TransformerEncoder(layer, len(layers), enable_nested_tensor=False)
    with torch.no_grad():
        for mod, lp in zip(enc.layers, layers):
            for dst, src in ((mod.self_attn.in_proj_weight, lp["wqkv"].T),
                             (mod.self_attn.in_proj_bias, lp["bqkv"]),
                             (mod.self_attn.out_proj.weight, lp["wo"].T),
                             (mod.self_attn.out_proj.bias, lp["bo"]),
                             (mod.linear1.weight, lp["w1"].T), (mod.linear1.bias, lp["b1"]),
                             (mod.linear2.weight, lp["w2"].T), (mod.linear2.bias, lp["b2"]),
                             (mod.norm1.weight, lp["ln1_scale"]), (mod.norm1.bias, lp["ln1_bias"]),
                             (mod.norm2.weight, lp["ln2_scale"]), (mod.norm2.bias, lp["ln2_bias"])):
                dst.copy_(src)
    return enc.to(dev).eval()


def k4_phase(rng, dev, card: str):
    """K4 at the DyGFormer train (600) and eval (4,400) seed counts, B = K = 20,
    D = 172; the serving path runs the eval count, whose entry is reported."""
    from tgm_tpu_torch.ops.recency_select import (
        recency_window_select,
        recency_window_select_plain,
    )

    B = K = DYG_NBRS
    D = WIKI_EDGE_DIM
    for S in (600, 2 * BATCH + BATCH * NUM_CANDIDATES):
        ids, times, _, wp, qt = k1_inputs(rng, S, B, dev)
        feats = torch.as_tensor(rng.normal(size=(S, B, D)).astype(np.float32), device=dev)
        args = (ids, times, feats, wp, qt)
        got = recency_window_select(*args, K)
        want = recency_window_select_plain(*args, K)
        torch.cuda.synchronize()
        err = max(_max_abs_err(got[:2], want[:2]), float((got[2] - want[2]).abs().max()))
        if err or not torch.equal(got[2], want[2]):
            raise AssertionError(f"K4 differs from its plain version at S={S}: {err}")
        selected = int((got[0] != -1).sum())
        # Bytes: ids, times, wp, qt read; the selected feature rows read; all outputs written.
        nbytes = 4 * (2 * S * B + 2 * S + 2 * S * K) + 4 * D * (selected + S * K)
        entry = _time_and_report(
            f"K4 recency_window_select S={S} B={B} K={K} D={D} (selected {selected}/{S * K})",
            lambda: recency_window_select(*args, K),
            lambda: recency_window_select_plain(*args, K),
            None, nbytes, 6 * S * B, err, card)
    return entry


def k5_phase(rng, stack, dev, card: str):
    """K5 at the DyGFormer eval shape: R = 4,200 joint sequences of (64, 200)."""
    from tgm_tpu_torch.ops.dyg_transformer import (
        STAGE_NAMES,
        _round_up,
        stack_flops,
        transformer_stack_fwd,
        transformer_stack_fwd_plain,
        transformer_stack_occupancy,
        transformer_stack_stage_ms,
    )

    H = DYG["num_heads"]
    R = BATCH * (NUM_CANDIDATES + 1)
    S = 2 * DYG["max_input_sequence_length"] // DYG["patch_size"]
    D = stack.D
    x = torch.as_tensor(rng.normal(size=(R, S, D)).astype(np.float32), device=dev)
    got = transformer_stack_fwd(x, stack, H)
    want = transformer_stack_fwd_plain(x, stack, H)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= K5_TOL * scale):
        raise AssertionError(f"K5 differs from its plain version: max |diff| {err}, "
                             f"max |plain| {scale}")
    log("kernels", f"K5 against its plain version: max |diff| {err:.4g} = "
                   f"{err / scale:.3g} * max |plain| ({scale:.4g}), median "
                   f"{float((got - want).abs().median()) / scale:.3g} * max; tolerance {K5_TOL} "
                   f"[{card}]")
    # The same comparison for a second pair of summation orders: the plain
    # version on the card (cuBLAS) against the plain version on the CPU.
    n = 64
    cpu = transformer_stack_fwd_plain(x[:n].cpu(), [{k: v.cpu() for k, v in lp.items()}
                                                    for lp in stack.layers], H)
    cw = want[:n].cpu()
    log("kernels", f"K5 plain version, card against CPU, first {n} sequences: max |diff| "
                   f"{float((cw - cpu).abs().max()) / scale:.3g} * max |plain|, median "
                   f"{float((cw - cpu).abs().median()) / scale:.3g}; the kernel on the same "
                   f"sequences: max {float((got[:n].cpu() - cpu).abs().max()) / scale:.3g}, "
                   f"median {float((got[:n].cpu() - cpu).abs().median()) / scale:.3g} [{card}]")
    # Where one call's time goes: each of the 5 kernels of each layer, from
    # CUDA events between them in one diagnostic call, beside the bytes this
    # design moves through device memory (h read 4 times and written twice per
    # layer; qkv, o and U written once and read once, in bf16).
    stage_ms = transformer_stack_stage_ms(x, stack)
    occ = transformer_stack_occupancy(S, D, H, stack.F)
    T, F, DHP = R * S, stack.F, _round_up(D // H, 16)
    design_bytes = stack.num_layers * T * (6 * 4 * D + 2 * 2 * (3 * H * DHP + H * DHP + F))
    log("kernels", "K5 stages, device ms of one call: " + "; ".join(
        f"layer {i}: " + ", ".join(f"{n} {float(v):.3f}" for n, v in zip(STAGE_NAMES, row))
        for i, row in enumerate(stage_ms)) + f"; sum {float(stage_ms.sum()):.3f} ms. CTAs per SM "
        f"{occ}. Device-memory traffic of this design {design_bytes / 1e9:.3f} GB, "
        f"{design_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
        f"[{card}]")
    lib = torch_transformer(stack.layers, H, dev)
    with torch.no_grad():
        lib_err = float((lib(x) - want).abs().max())
        with torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False):
            lib_bf16_err = float((lib(x).float() - want).abs().max())

    def run_lib_bf16():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False):
            lib(x)

    def run_lib_fp32():
        with torch.no_grad():
            lib(x)

    lib_fp32_us, _ = cuda_time_us(run_lib_fp32, K5_TIMING_ITERS, graph=False)
    log("kernels", f"K5 library yardstick torch.nn.TransformerEncoder: fp32 {lib_fp32_us:.1f} us "
                   f"(max |diff| to plain {lib_err:.4g}), bf16 autocast timed below (max |diff| "
                   f"to plain {lib_bf16_err:.4g}) [{card}]")
    nbytes = 2 * 4 * R * S * D + 2 * stack.w.numel() + 4 * stack.p.numel()
    flops = stack_flops(R, S, D, stack.layers[0]["w1"].shape[1], stack.num_layers)
    entry = _time_and_report(
        f"K5 transformer_stack_fwd R={R} S={S} D={D} H={H} L={stack.num_layers} "
        f"({flops / 1e9:.1f} GFLOP)",
        lambda: transformer_stack_fwd(x, stack, H),
        lambda: transformer_stack_fwd_plain(x, stack, H),
        run_lib_bf16, nbytes, flops, err, card,
        iters=K5_TIMING_ITERS, graph=False, ops_per_s=BF16_OPS_PER_S)
    entry["library_fp32_ms"] = lib_fp32_us / 1e3
    entry["max_rel_err"] = err / scale
    entry["stage_ms"] = {n: [float(v) for v in stage_ms[:, i]] for i, n in enumerate(STAGE_NAMES)}
    entry["ctas_per_sm"] = occ
    return entry


def kernel_phase(rng, dev, card: str):
    """K1-K3 at the TGN serving shapes: exact against their plain versions, timed.

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
    """The wrappers of the serving paths' kernels; each counts its launches."""
    from tgm_tpu_torch.ops.dyg_transformer import transformer_stack_fwd
    from tgm_tpu_torch.ops.recency_select import recency_window_select, recency_window_select_eid
    from tgm_tpu_torch.ops.scatter_cells import scatter_cells, tgn_store_scatter_1d

    return (recency_window_select_eid, scatter_cells, tgn_store_scatter_1d,
            recency_window_select, transformer_stack_fwd)


def check_launches(path: str, launches, need, n_batches: int) -> None:
    for name, per_batch in need.items():
        if launches[name] < per_batch * n_batches:
            raise AssertionError(f"{path}: {name} launched {launches[name]} times "
                                 f"for {n_batches} batches")


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
    check_launches("TGN serve", launches, {"recency_window_select_eid": 1, "scatter_cells": 3,
                                           "tgn_store_scatter_1d": 1}, n_batches)
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


# ---------------------------------------------------------------------- #
# The DyGFormer serving path
# ---------------------------------------------------------------------- #
def make_dyg_models(seed: int):
    from tgm_tpu_torch.nn import DyGFormer, LinkPredictor

    torch.manual_seed(seed)
    encoder = DyGFormer(**DYG)
    decoder = LinkPredictor(node_dim=DYG["output_dim"], hidden_dim=DYG["output_dim"])
    node_x = np.random.default_rng(seed).normal(size=(WIKI_NODES, 1)).astype(np.float32)
    return encoder.eval(), decoder.eval(), node_x


def make_dyg_pipeline(cands, models, device):
    from tgm_tpu_torch.hooks import HookManager, RecencyNeighborHook, TGBNegativeEdgeSamplerHook
    from tgm_tpu_torch.train import build_dygformer_eval_core

    encoder, decoder, node_x = models
    hm = HookManager(keys=["val", "test"])
    for split in ("val", "test"):
        hm.register(split, TGBNegativeEdgeSamplerHook(cands[split], device=device))
    # The feature-buffer layout (no edge_x_full), as the DyGFormer example registers it.
    rec = RecencyNeighborHook(WIKI_NODES, [DYG_NBRS], ["edge_src", "edge_dst", "neg"],
                              ["edge_time", "edge_time", "neg_time"], edge_dim=WIKI_EDGE_DIM,
                              device=device)
    hm.register_shared(rec)
    eval_core = build_dygformer_eval_core(encoder.to(device), decoder.to(device),
                                          torch.as_tensor(node_x, device=device), WIKI_NODES)
    return hm, rec, eval_core


def dyg_serve_phase(val, test, cands, models, dev, card, kernel_ms):
    from tgm_tpu_torch import DGraph
    from tgm_tpu_torch.train import DeviceEdgeStream, hook_epoch

    hm, _, eval_core = make_dyg_pipeline(cands, models, dev)
    val_src, val_dst, _ = DGraph(val)._storage.get_edges(DGraph(val)._slice)
    active = len(np.unique(np.concatenate([val_src, val_dst])))
    n_batches, n_edges, seconds, mrr = 0, 0, 0.0, {}
    for f in kernel_wrappers():
        f.launches = 0
    for split, d in (("val", val), ("test", test)):
        dg = DGraph(d)
        stream = DeviceEdgeStream(dg, BATCH, device=dev)
        epoch, states = hook_epoch(stream, hm, split, dg, eval_core)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, states, (s, c) = epoch(None, states)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hm.adopt_states(split, states)
        mrr[split] = float(s.sum() / c.sum())
        n_batches += stream.num_batches
        n_edges += stream.num_edges
        seconds += dt
        log("dyg-serve", f"{split}: {stream.num_edges} edges in {stream.num_batches} batches, "
                         f"{dt:.3f} s, {stream.num_edges / dt:.0f} edges/s, "
                         f"MRR {mrr[split]:.4f} [{card}]")
    launches = {f.__name__: f.launches for f in kernel_wrappers()}
    check_launches("DyGFormer serve", launches, {"recency_window_select": 1,
                                                 "transformer_stack_fwd": 1,
                                                 "scatter_cells": 2}, n_batches)
    if not all(np.isfinite(v) and 0.0 < v <= 1.0 for v in mrr.values()):
        raise AssertionError(f"MRR out of range: {mrr}")
    torch.cuda.synchronize()
    # Each kernel's device time per call (kernels phase, same shapes) times its
    # launches here, as a share of the serve wall time.
    shares = {name: ms * launches[name] / 1e3 / seconds for name, ms in kernel_ms.items()}
    log("dyg-serve", f"wall {seconds:.3f} s, {seconds / n_batches * 1e3:.2f} ms per batch; "
                     f"share of the wall time in each kernel (kernels-phase device time x "
                     f"launches): " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
        + f" [{card}]")
    log("dyg-serve", f"val_mrr={mrr['val']:.6f} test_mrr={mrr['test']:.6f} "
                     f"serve_edges_per_s={n_edges / seconds:.0f} batches={n_batches} "
                     f"distinct_nodes_active_in_val={active} launches={launches} per_batch="
                     f"{ {k: v / n_batches for k, v in launches.items()} } [{card}]")
    return launches


def dyg_agree_phase(val, cands, models, dev, card):
    from tgm_tpu_torch import DGraph
    from tgm_tpu_torch.train import DeviceEdgeStream

    encoder, decoder, node_x = models
    cpu_models = (copy.deepcopy(encoder).to("cpu"), copy.deepcopy(decoder).to("cpu"), node_x)
    runs = []  # the card's run, then the CPU's
    for device, mods in ((dev, models), (torch.device("cpu"), cpu_models)):
        t0 = time.perf_counter()
        hm, rec, eval_core = make_dyg_pipeline(cands, mods, device)
        dg = DGraph(val)
        stream = DeviceEdgeStream(dg, BATCH, device=device)
        fn, states = hm.as_transform("val", dg)
        zs, sums = [], []
        for i in range(DYG_AGREE_BATCHES):
            states, batch = fn(states, stream.batch_at(i))
            z = eval_core.embed(batch)
            s, _ = eval_core.score(batch, *z)
            zs.append(torch.cat(z).cpu())
            sums.append(float(s))
        # The recency buffers are updated in place: the hook's state is the final one.
        runs.append(([t.cpu() for t in rec.state], zs, sums, time.perf_counter() - t0))
    (g_rec, g_z, g_sums, g_s), (c_rec, c_z, c_sums, c_s) = runs
    for name, g, c in zip(("nbr_ids", "nbr_times", "nbr_feats", "write_pos"), g_rec, c_rec):
        if not torch.equal(g, c):
            raise AssertionError(f"DyGFormer recency {name} differs between card and CPU")
    scale = max(float(c.abs().max()) for c in c_z)
    z_err = max(float((g - c).abs().max()) for g, c in zip(g_z, c_z))
    mrr_err = max(abs(a - b) for a, b in zip(g_sums, c_sums))
    if not (z_err <= K5_TOL * scale and mrr_err <= 0.5):
        raise AssertionError(f"DyGFormer card vs CPU: embeddings {z_err} (max |z| {scale}), "
                             f"MRR sums {mrr_err}")
    log("dyg-agree", f"{DYG_AGREE_BATCHES} val batches: recency state exact (feature buffer "
                     f"included), max |z| diff {z_err:.4g} = {z_err / scale:.3g} * max |z|, max "
                     f"per-batch MRR-sum diff {mrr_err:.4g} (card {g_sums}, CPU {c_sums}); "
                     f"card {g_s:.1f} s, CPU {c_s:.1f} s [{card}]")


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
    t_start = t0 = time.perf_counter()
    _native.build_all()
    nvcc_release = subprocess.run([_native._nvcc(), "--version"], capture_output=True, text=True,
                                  check=True, timeout=60).stdout.strip().splitlines()[-1]
    log("build", f"{time.perf_counter() - t0:.1f} s (nvcc {_native.build_seconds:.1f} s) "
                 f"torch {torch.__version__} cuda {torch.version.cuda} python "
                 f"{sys.version.split()[0]}; {nvcc_release} [{card}]")

    rng = np.random.default_rng(args.seed)
    report = kernel_phase(rng, dev, card)
    report["recency_window_select"] = k4_phase(rng, dev, card)
    dyg_models = make_dyg_models(args.seed)
    report["transformer_stack_fwd"] = k5_phase(rng, dyg_models[0].to(dev).stack_weights(), dev,
                                               card)

    t0 = time.perf_counter()
    data, val, test, cands = build_stream(args.seed)
    models = make_models(args.seed)
    log("serve", f"stream {WIKI_NODES} nodes, {WIKI_EDGES} edges, edge dim {WIKI_EDGE_DIM}, "
                 f"val {val.num_edge_events} / test {test.num_edge_events} edges, "
                 f"built in {time.perf_counter() - t0:.1f} s")
    launches = serve_phase(data, val, test, cands, models, dev, card)
    agree_phase(data, val, cands, models, dev, card)
    dyg_launches = dyg_serve_phase(
        val, test, cands, dyg_models, dev, card,
        {name: report[name]["ms"] for name in ("recency_window_select", "transformer_stack_fwd",
                                               "scatter_cells")})
    dyg_agree_phase(val, cands, dyg_models, dev, card)

    # name: (source, Pallas function replaced, path whose serve run counts its launches)
    kernels_of = {
        "recency_window_select_eid": (K14_SRC, "tgm_tpu/ops/pallas/recency_select.py:209", launches),
        "scatter_cells": (K23_SRC, "tgm_tpu/ops/pallas/scatter_cells.py:53", launches),
        "tgn_store_scatter_1d": (K23_SRC, "tgm_tpu/ops/pallas/scatter_cells.py:111", launches),
        "recency_window_select": (K14_SRC, "tgm_tpu/ops/pallas/recency_select.py:259",
                                  dyg_launches),
        "transformer_stack_fwd": (K5_SRC, "tgm_tpu/ops/pallas/dyg_transformer.py:167",
                                  dyg_launches),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": counts[name], **report[name]}
               for name, (src, replaces, counts) in kernels_of.items()]
    kernels[0]["also_replaces"] = "tgm_tpu/ops/pallas/recency_select.py:156"
    kernels[1]["launches_dygformer_serve"] = dyg_launches["scatter_cells"]
    log("done", f"{time.perf_counter() - t_start:.1f} s from the build to here [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
