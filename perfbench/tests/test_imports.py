"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names (before the
first dot) are compared whole: ``libavif_tpu_torch`` begins with
``libavif_tpu`` and is allowed."""

import ast
import json
import pathlib
import subprocess
import sys

from perfbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "libavif_tpu"}


def _modules(code: str) -> set:
    """Top-level names in sys.modules after ``code`` ran in a fresh process."""
    probe = f"import sys, json\nsys.path.insert(0, {str(ROOT)!r})\n{code}\n" \
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _benchmark_modules() -> list:
    return sorted("perfbench." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
                  for p in BENCH.rglob("*.py") if "tests" not in p.parts and p.name != "__init__.py")


def test_a_run_loads_no_jax():
    imports = "\n".join(f"import {m}" for m in _benchmark_modules())
    drive = ("import torch\nfrom perfbench.tests.helpers import tiny_cell, run_tiny\n"
             "res, _ = run_tiny(tiny_cell())\nassert res['correct'], res")
    names = _modules(imports + "\n" + drive)
    assert "libavif_tpu_torch" in names and "perfbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _modules("import perfbench.reference.judge, perfbench.reference.stream, perfbench.control")
    assert "libavif_tpu_torch" not in names and not names & FORBIDDEN


def test_reference_sources_import_only_numpy_torch_and_the_standard_library():
    allowed = {"numpy", "torch", "__future__", "contextlib", "dataclasses", "functools", "struct"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = set() if node.level else {node.module.split(".")[0]}
            else:
                continue
            assert tops <= allowed, (path.name, tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "libavif_tpu_torch_probe", sys)
    assert run.forbidden_modules() == [] or set(run.forbidden_modules()) <= FORBIDDEN
    assert "libavif_tpu_torch_probe".split(".")[0] not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "libavif_tpu.probe", sys)
    assert "libavif_tpu" in run.forbidden_modules()
