"""The controls of ``correct``: the plain reference computed a precision
step below the configuration's, put in the program's place, must come out
not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

For each seed and each control of the configuration's reference
(``CONTROLS``: TGN's "tf32"; DyGFormer's "stack_fp8", "rest_tf32" and
"rest_bf16", each lowering one part of the model a step): the cell's
inputs from the seed, the reference at the configuration's precision and
at the control's, both over the batches a run compares, held to the
cell's numbers and limits. Prints one JSON line a seed and control. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.yard import candidates, checks, evalcell, evalplan, stream as gen  # noqa: E402
from portbench.yard import weights  # noqa: E402
from portbench.yard.seeds import derive  # noqa: E402


def control_numbers(cell, seed: int, device: torch.device, controls=None) -> dict:
    """``{control: the cell's compared numbers}`` of each control against
    the reference, over the batches a run compares: the kept ones' scores,
    products and captures, the scored ones' MRR sums, the state after the
    last test batch."""
    ref_mod = cell.module("reference")
    Program = cell.module("program").Program
    shapes, extra = cell.module("program").weight_shapes(cell.cfg)
    B = cell.traffic["protocol"]["batch_size"]
    s = gen.generate(cell.traffic["stream"], derive(seed, "stream"))
    cands = candidates.generate(cell.traffic["protocol"], s, derive(seed, "candidates"))
    W = weights.make(shapes, derive(seed, "weights"), device)
    if extra is not None:
        W.update(extra(s, seed, device))
    n_val = -(-(s.bounds["val"][1] - s.bounds["val"][0]) // B)
    n_test = -(-(s.bounds["test"][1] - s.bounds["test"][0]) // B)
    samples = evalplan.sample_keys(seed, n_val, n_test, evalcell.KEPT)
    plan = evalplan.Plan(samples=samples, end=("test", n_test - 1),
                         keep_rows=evalcell.keep_rows(s, B, cands["val"].shape[1]),
                         scored=evalplan.sample_keys(seed, n_val, n_test, evalcell.SCORED),
                         capture_rows=getattr(Program, "CAPTURE_ROWS", None))
    ref = ref_mod.run(cell.cfg, s, cands, cell.traffic, seed, W, plan, device, fmt="fp32")
    out = {}
    for fmt in controls or ref_mod.CONTROLS:
        low = ref_mod.run(cell.cfg, s, cands, cell.traffic, seed, W, plan, device, fmt=fmt)
        keys = sorted(low["mrr"], key=lambda k: (k[0] != "val", k[1]))
        got = {"products": low["products"], "captures": low.get("captures", {}),
               "state": low["state"],
               "scores": {k: low["scores"][k] for k in samples},
               "outs": torch.tensor([low["mrr"][k] for k in keys], dtype=torch.float64),
               "batch_log": [(k[0], k[1], int(low["mrr"][k][1])) for k in keys]}
        out[fmt] = ref_mod.numbers(got, ref, cell.limits)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.Cell(bench, args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for fmt, numbers in control_numbers(cell, seed, device).items():
            ok, compared = checks.verdict(numbers, cell.limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": fmt,
                              "control_correct": ok, "compared": compared,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
