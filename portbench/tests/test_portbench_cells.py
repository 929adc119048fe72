"""A cell added as new files and a manifest entry alone is found and run,
and no file that was there changes."""

import hashlib
import json
import shutil

import torch

from portbench import run


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_dummy_cell_from_new_files(tmp_path):
    import tiny

    bench = tiny.tiny_bench(tmp_path)
    base = tmp_path / "portbench"
    before = _digest(base)
    # New files only: a configuration, a traffic mix, a metric, the limits.
    shutil.copytree(base / "configs" / "tgn-wiki", base / "configs" / "dummy-tgn")
    cfg = json.loads((base / "configs" / "dummy-tgn" / "config.json").read_text())
    cfg.update(memory_dim=6, embedding_dim=6)
    (base / "configs" / "dummy-tgn" / "config.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "tgb-q999.json").read_text())
    traffic["stream"] = dict(traffic["stream"], items=6)
    (base / "traffic" / "dummy-q5.json").write_text(json.dumps(traffic))
    (base / "limits" / "dummy-tgn.dummy-q5.json").write_text(
        (base / "limits" / "tgn-wiki.tgb-q999.json").read_text())
    (base / "metrics" / "dummy_batches.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    bench["configs"].append({"name": "dummy-tgn", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-tgn/config.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "dummy-tgn.dummy-q5", "config": "dummy-tgn",
                               "traffic": "dummy-q5", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_batches", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "eval_edges_per_s", "workloads": ["dummy-tgn.dummy-q5"]})
    cell = run.Cell(bench, "dummy-tgn.dummy-q5", root=tmp_path, base=base)
    res = run.run_cell(cell, 9, 0.3, trace=True, device=torch.device("cpu"))
    assert res["correct"], res["compared"]
    assert res["metrics"]["dummy_batches"]["value"] > 0
    # The cells that were there do not report the new metric.
    old = run.Cell(bench, "tgn-wiki.tgb-q999", root=tmp_path, base=base)
    assert "dummy_batches" not in {m["name"] for m in old.per_layer}
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
