"""The link-prediction eval cell: TGB's protocol served by a configuration's
``Program`` and judged by its ``reference``. A configuration of this kind
names it in its ``program.py`` (``run_cell`` calls ``run`` here); another
kind of cell brings a runner of its own that returns a ``CellRun``.

Set-up makes the cell's stream, candidate tables and weights from
``--seed``, folds the train split into the state, keeps a snapshot and
warms up on the cell's own shapes; the window then serves the splits that
the traffic file's ``passes`` lists (val, then test) from the snapshot,
again and again, for ``--seconds``; after it the plain reference works the
same batches out again, and its ``numbers`` compares them with what the
window produced.

The ``Program`` class of a configuration: ``Program(cfg, stream, cands,
traffic, seed, weight_seed, device)`` with ``weights`` (the dict the
reference gets too), ``setup`` (``linkpred.LinkPredSetup``), ``core``,
``carry``, ``captures`` (``window.Capture`` list: what the window keeps of
the sampled batches besides the hook products; ``scores`` is the
decoder's output), ``fold()``, ``restore()``, ``scores_layout(out, B, Q)``
and ``final_state()``.
"""

from __future__ import annotations

import gc
import time

import torch

from . import candidates, cellrun, evalplan, stream as gen, window
from .seeds import derive

# Batches whose hook products and captures the window keeps, and batches
# whose scores and MRR the reference works out (the kept ones among them).
KEPT, SCORED = 6, 40


def keep_rows(s, B: int, Q: int) -> int:
    """Seed rows of a batch's hook products kept: [src | dst | the unique
    candidates, at most every item]."""
    return 2 * B + min(s.num_items, B * Q)


def run(Program, cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_process: float, warm_batches: int = 4) -> cellrun.CellRun:
    reference, counts = cell.module("reference"), cell.module("counts")
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # ---- set-up ------------------------------------------------------- #
    s = gen.generate(cell.traffic["stream"], derive(seed, "stream"))
    cands = candidates.generate(cell.traffic["protocol"], s, derive(seed, "candidates"))
    prog = Program(cell.cfg, s, cands, cell.traffic, seed, derive(seed, "weights"), device)
    W = prog.weights
    t0 = time.perf_counter()
    prog.fold()
    sync()
    fold_s = time.perf_counter() - t0
    B = cell.traffic["protocol"]["batch_size"]
    passes = tuple(cell.traffic["passes"])
    rows = keep_rows(s, B, cands["val"].shape[1])
    warm = window.Recorder(device, trace=False, keep_rows=rows, probe=True,
                           limit_batches=warm_batches)
    with warm.hooked(prog.captures):
        window.serve(prog, warm, passes)  # a few batches: every pass has the same shapes
    n_val, n_test = (prog.setup.streams[k].num_batches for k in ("val", "test"))
    scored = evalplan.sample_keys(seed, n_val, n_test, SCORED)
    kept = evalplan.sample_keys(seed, n_val, n_test, KEPT)
    rec = window.Recorder(device, trace=trace, samples=kept, keep_rows=rows)
    rec.allocate(warm.shapes)
    sync()
    setup_s = time.perf_counter() - t_process

    # ---- window --------------------------------------------------------- #
    with rec.hooked(prog.captures), cellrun.Window(trace, device) as w:
        rec.deadline = w.t0 + seconds
        window.serve(prog, rec, passes)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # What the window produced, off the device; then the program goes.
    outs = torch.stack([torch.stack([o[0].double(), o[1].double()]) for o in
                        (r.out for r in rec.recs)]).cpu()
    intervals = _intervals(rec) if cuda else []
    batch_log = [(r.split, r.index, r.n_edges, r.t_fetch, r.t_step, r.t_done) for r in rec.recs]
    got = {"products": {}, "captures": {}, "outs": outs, "batch_log": batch_log}
    for key, caps in rec.captures.items():
        got["products"][key] = {n[len("product."):]: t.cpu() for n, t in caps.items()
                                if n.startswith("product.")}
        got["captures"][key] = {n: t.cpu() for n, t in caps.items()
                                if not n.startswith("product.")}
    got["scores"] = {k: prog.scores_layout(c["scores.0"], B, cands[k[0]].shape[1])
                     for k, c in got["captures"].items()}
    got["state"] = prog.final_state()
    last_pass = rec.recs[rec.pass_starts[-1][0]:] or rec.recs[-1:]
    end = (last_pass[-1].split, last_pass[-1].index)
    info = {"window_s": w.seconds, "batches": len(batch_log), "fold_s": fold_s,
            "setup_s": setup_s, "passes": len(rec.pass_starts)}
    summary = w.summary()
    del prog, rec, w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- reference and comparison --------------------------------------- #
    t_r = time.perf_counter()
    plan = evalplan.Plan(samples=set(got["products"]), scored=scored | set(got["products"]),
                         end=end, keep_rows=rows,
                         capture_rows=getattr(Program, "CAPTURE_ROWS", None))
    ref = reference.run(cell.cfg, s, cands, cell.traffic, seed, W, plan, device)
    numbers = reference.numbers(got, ref, cell.limits)
    info["reference_s"] = time.perf_counter() - t_r
    failed = sum(n for (sp, i, n, *_), o in zip(batch_log, outs)
                 if float(o[1]) != ref["counts"][(sp, i)])
    data = cellrun.RunData(cfg=cell.cfg, traffic=cell.traffic, counts=counts, batches=batch_log,
                           intervals_ms=intervals, window_s=info["window_s"], setup_s=setup_s,
                           fold_s=fold_s, peak_bytes=peak, trace=summary, sizes=ref["sizes"],
                           device=device)
    return cellrun.CellRun(numbers=numbers, attempted=int(sum(b[2] for b in batch_log)),
                           failed=int(failed), data=data, peak_bytes=int(peak), summary=summary,
                           info=info)


def _intervals(rec):
    """ms between consecutive batch-completion events; a pass's first batch
    from the event recorded after its snapshot restore."""
    torch.cuda.synchronize()
    starts = dict(rec.pass_starts)
    out, prev = [], None
    for i, r in enumerate(rec.recs):
        prev = starts.get(i, prev)
        out.append(prev.elapsed_time(r.event))
        prev = r.event
    return out
