"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole); the references load nothing of the program."""

import subprocess
import sys
import textwrap

from tiny import HERE

ROOT = HERE.parent


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_references_load_nothing_of_the_program():
    out = _run("""
        import sys, importlib.util
        sys.path.insert(0, ".")
        import portbench.yard.refcommon, portbench.yard.evalplan, portbench.yard.precision
        import portbench.yard.checks, portbench.yard.stream, portbench.yard.candidates
        for name in ("tgn-wiki", "dygformer-wiki"):
            for stem in ("reference", "counts"):
                p = f"portbench/configs/{name}/{stem}.py"
                spec = importlib.util.spec_from_file_location(stem + name.replace("-", "_"), p)
                spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    top = eval(out.strip().splitlines()[-1])
    assert "tgm_tpu_torch" not in top and "tgm_tpu" not in top and "jax" not in top


def test_a_run_loads_no_jax(tmp_path):
    out = _run(f"""
        import sys
        sys.path.insert(0, "."); sys.path.insert(0, "portbench/tests")
        from pathlib import Path
        import torch
        from portbench import run
        import tiny
        bench = tiny.tiny_bench(Path({str(tmp_path)!r}))
        cell = run.Cell(bench, "tgn-wiki.tgb-q999", root=Path({str(tmp_path)!r}),
                        base=Path({str(tmp_path)!r}) / "portbench")
        res = run.run_cell(cell, 1, 0.2, trace=False, device=torch.device("cpu"))
        print(res["correct"], run.forbidden_modules(), "tgm_tpu_torch" in sys.modules)
    """)
    assert out.strip().splitlines()[-1] == "True [] True"
