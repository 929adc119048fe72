"""Run one cell of the benchmark of ``tgm_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``tgm_tpu_torch/`` (the port builds its kernels with nvcc into
``tgm_tpu_torch/_build/`` there, once a checkout). The cell's
configuration runs it: ``configs/<config>/program.py``'s ``run_cell`` makes
the inputs from ``--seed``, sets up, warms up, measures for ``--seconds``
and has its plain reference work out the numbers that decide ``correct``
(``yard/evalcell.py`` for the link-prediction eval cells). This file reads
the manifest, looks for the card, holds the numbers to
``limits/<cell>.json``, reads each metric by its ``metrics/<metric>.py``,
checks that nothing of JAX was loaded, and prints the result: one JSON
object as the last line of standard output, with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read under ``torch.profiler``),
``device``, with ``--trace 1`` also ``breakdown``, and last ``compared``:
each number compared with its limit.

Everything of one configuration, traffic mix, per-layer metric or cell
lives in files of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>/`` (``config.json``, ``program.py``, ``reference.py``,
``counts.py``), ``traffic/<mix>.json``, ``metrics/<metric>.py`` and
``limits/<cell>.json``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tgm_tpu")

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files and metrics."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT, base: Path = HERE) -> None:
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
        self.w = cells[workload]
        self.name = workload
        self.base = base
        cfg_entry = {c["name"]: c for c in bench["configs"]}[self.w["config"]]
        self.cfg = json.loads((root / cfg_entry["file"]).read_text())
        self.cfg_dir = (root / cfg_entry["file"]).parent
        self.traffic = json.loads((base / "traffic" / f"{self.w['traffic']}.json").read_text())
        self.limits = json.loads((base / "limits" / f"{workload}.json").read_text())
        applies = lambda m: workload in m.get("workloads", [workload])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def module(self, stem: str):
        return load_module(self.cfg_dir / f"{stem}.py", _modname(stem, self.w["config"]))

    def reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py", _modname("metric", metric))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             warm_batches: int = 4) -> dict:
    """One run of ``cell``: its configuration's ``run_cell``, the numbers
    held to their limits, the metrics read."""
    from portbench.yard import checks

    program = cell.module("program")
    got = program.run_cell(cell, seed, seconds, trace, device, T_PROCESS,
                           warm_batches=warm_batches)
    correct, compared = checks.verdict(got.numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(got.data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": got.attempted,
        "failed": got.failed,
        "metrics": metrics,
        "device": _device(device, got.peak_bytes, got.summary),
    }
    if got.summary is not None:
        result["breakdown"] = _breakdown(got.summary)
    result["compared"] = compared
    result["_info"] = got.info
    return result


def _device(device, peak, summary) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
         "memory_peak_bytes": int(peak)}
    if summary is not None:
        d["busy_s"] = summary.busy_s
        d["window_s"] = summary.window_s
    return d


def _breakdown(summary) -> dict:
    ops = sorted(summary.device_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a non-negative whole number")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell.w["chips"]):
        print(f"portbench: the cell needs {cell.w['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    info = result.pop("_info")
    print(json.dumps({"info": info}), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
