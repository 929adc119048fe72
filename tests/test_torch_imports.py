"""The port stands alone: importing it (and ``chip_smoke.py``) loads no JAX.

Runs in a subprocess, because this test process already imported JAX.
"""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import tgm_tpu_torch
names = ["tgm_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    tgm_tpu_torch.__path__, "tgm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax") or m.startswith("tgm_tpu."))
assert not bad, bad
assert len(names) > 20, names
for name in ("tgm_tpu_torch.examples.linkproppred.tgn", "tgm_tpu_torch.examples.serving.tgn_scoring",
             "tgm_tpu_torch.train.tgn_pipeline", "tgm_tpu_torch.train.checkpoint",
             "tgm_tpu_torch.examples.linkproppred.dygformer", "tgm_tpu_torch.nn.modules.dropout",
             "tgm_tpu_torch.examples.linkproppred.tgat", "tgm_tpu_torch.train.tgat_pipeline",
             "tgm_tpu_torch.nn.encoder.tgat", "tgm_tpu_torch.nn.modules.attention",
             "tgm_tpu_torch.ops.segment", "tgm_tpu_torch.hooks.dedup",
             "tgm_tpu_torch.nn.modules.aggregation", "tgm_tpu_torch.train.hook_pipeline",
             "tgm_tpu_torch.timedelta", "tgm_tpu_torch.data.loader", "tgm_tpu_torch.train.stream",
             "tgm_tpu_torch.examples.nodeproppred.tgn",
             "tgm_tpu_torch.examples.nodeproppred.tgat",
             "tgm_tpu_torch.nn.modules.mlp_mixer", "tgm_tpu_torch.nn.base",
             "tgm_tpu_torch.nn.encoder.tpnet", "tgm_tpu_torch.examples._linkpred_common",
             "tgm_tpu_torch.examples.linkproppred.graphmixer",
             "tgm_tpu_torch.examples.linkproppred.tpnet",
             "tgm_tpu_torch.examples.nodeproppred.tpnet",
             "tgm_tpu_torch.nn.encoder.ctan", "tgm_tpu_torch.nn.decoder.ncnpred",
             "tgm_tpu_torch.examples.linkproppred.ctan",
             "tgm_tpu_torch.examples.linkproppred.tncn",
             "tgm_tpu_torch.nn.modules.graph_conv", "tgm_tpu_torch.nn.encoder.gcn",
             "tgm_tpu_torch.nn.encoder.tgcn", "tgm_tpu_torch.nn.encoder.gclstm",
             "tgm_tpu_torch.nn.encoder.roland", "tgm_tpu_torch.train.snapshot",
             "tgm_tpu_torch.examples._snapshot_common",
             "tgm_tpu_torch.examples.linkproppred.gcn",
             "tgm_tpu_torch.examples.linkproppred.tgcn",
             "tgm_tpu_torch.examples.linkproppred.gclstm",
             "tgm_tpu_torch.examples.linkproppred.roland",
             "tgm_tpu_torch.examples.nodeproppred.gcn",
             "tgm_tpu_torch.examples.nodeproppred.tgcn",
             "tgm_tpu_torch.examples.nodeproppred.gclstm",
             "tgm_tpu_torch.examples.nodeproppred.persistant_forecast",
             "tgm_tpu_torch.examples.graphproppred.gcn",
             "tgm_tpu_torch.examples.graphproppred.tgcn",
             "tgm_tpu_torch.examples.graphproppred.persistant_forecast",
             "tgm_tpu_torch.nn.modules.edgebank", "tgm_tpu_torch.nn.modules.poptrack",
             "tgm_tpu_torch.nn.modules.t_comem", "tgm_tpu_torch.nn.modules.pair_table",
             "tgm_tpu_torch.data.tgb", "tgm_tpu_torch.util.seed", "tgm_tpu_torch.util.logging",
             "tgm_tpu_torch.examples.linkproppred.edgebank",
             "tgm_tpu_torch.examples.linkproppred.poptrack",
             "tgm_tpu_torch.examples.linkproppred.base3",
             "tgm_tpu_torch.examples.linkproppred.tgb_seq.edgebank",
             "tgm_tpu_torch.examples.linkproppred.thgl.edgebank",
             "tgm_tpu_torch.examples.linkproppred.tkgl.edgebank",
             "tgm_tpu_torch.native", "tgm_tpu_torch.train.chunked",
             "tgm_tpu_torch.parallel", "tgm_tpu_torch.parallel.mesh",
             "tgm_tpu_torch.parallel.sharding", "tgm_tpu_torch.parallel.temporal",
             "tgm_tpu_torch.parallel.spmd",
             "tgm_tpu_torch.examples.analytics.batch_analytics_example",
             "tgm_tpu_torch.examples.analytics.dos",
             "tgm_tpu_torch.examples.analytics.node_analytics_example"):
    assert name in names, names
print("imported", len(names))
"""


def _run(code, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, **kw)


def test_port_imports_no_jax():
    out = _run(_PROBE)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from tgm_tpu_torch.hooks.neighbors import recency_eid_init\n"
        "try:\n"
        "    recency_eid_init(4, 3)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
    )
    out = _run(code)
    if "AssertionError" in out.stderr:
        pytest.skip("a CUDA device is present: the default device is usable")
    assert out.returncode == 0 and "raised" in out.stdout, out.stderr


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
