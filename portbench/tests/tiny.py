"""Tiny cells for the CPU tests: the real configurations' files with
small widths and a small stream, laid out as the harness finds them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TINY_STREAM = {"users": 40, "items": 12, "edges": 900, "time_span_s": 100000, "edge_dim": 6,
               "split": [0.7, 0.15, 0.15],
               "user_activity": {"law": "lognormal", "sigma": 1.0},
               "item_popularity": {"law": "lognormal", "sigma": 1.0}, "repeat_prob": 0.8}
TINY_CONFIGS = {
    "tgn-wiki": {"memory_dim": 8, "embedding_dim": 8, "time_dim": 4, "num_neighbors": 3,
                 "edge_dim": 6, "decoder_hidden": 8},
    "dygformer-wiki": {"channel_embedding_dim": 4, "ffn_dim": 64, "max_input_sequence_length": 8,
                       "num_neighbors": 7, "time_dim": 4, "output_dim": 6, "edge_dim": 6,
                       "node_feat_dim": 6, "decoder_hidden": 6},
}
TINY_CANDIDATES = {"tgb-q999": {"kind": "all_other_items"},
                   "tgb-q20": {"kind": "historical_random", "historical": 3, "random": 3}}


def tiny_bench(tmp: Path, limits_scale: float = 1.0) -> dict:
    """A manifest of the two cells at tiny size under ``tmp`` (files copied
    from the real ones, sizes shrunk), and the manifest itself."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    base = tmp / "portbench"
    for d in ("traffic", "limits", "metrics", "configs"):
        (base / d).mkdir(parents=True, exist_ok=True)
    for f in (HERE / "metrics").glob("*.py"):
        shutil.copy(f, base / "metrics" / f.name)
    for c in bench["configs"]:
        src_dir = HERE / "configs" / c["name"]
        dst_dir = base / "configs" / c["name"]
        shutil.copytree(src_dir, dst_dir, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cfg = json.loads((src_dir / "config.json").read_text())
        cfg.update(TINY_CONFIGS[c["name"]])
        (dst_dir / "config.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        t["stream"] = TINY_STREAM
        t["protocol"] = {"batch_size": 20, "candidates": TINY_CANDIDATES[w["traffic"]]}
        (base / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        shutil.copy(HERE / "limits" / f"{w['name']}.json", base / "limits" / f"{w['name']}.json")
    return bench
