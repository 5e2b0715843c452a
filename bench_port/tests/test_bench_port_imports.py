"""No module the benchmark runs imports JAX or the JAX package; the
reference and the work counts import nothing of the port either. Top-level
module names are compared whole: ``dmesh2_renderer_tpu_torch`` is the
port, ``dmesh2_renderer_tpu`` the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dmesh2_renderer_tpu"}
PORT = "dmesh2_renderer_tpu_torch"


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


def test_reference_and_counts_import_nothing_of_the_port():
    for path in modules():
        rel = path.relative_to(BENCH).parts
        if rel[0] in ("reference", "counts") or path.name == "counting.py":
            assert PORT not in imported_tops(path), path


def test_loading_the_reference_and_counts_loads_no_port_and_no_jax():
    code = (
        "import sys, json, importlib\n"
        "from bench_port import harness\n"
        "import bench_port.reference.render, bench_port.counting\n"
        "for k in harness.kernel_names(): harness.load_module('counts', k)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    tops = set(json.loads(out.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {PORT})


def test_a_whole_cpu_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time, json\n"
        "sys.path.insert(0, %r)\n"
        "import conftest, pytest\n"
        "from bench_port import harness\n"
        "class MP:\n"
        "    def setattr(self, obj, name, value): setattr(obj, name, value)\n"
        "spec = conftest.tiny_bench.__wrapped__(__import__('pathlib').Path(%r), MP())\n"
        "harness.run_cell(spec, 'tiny.peel4', 3, 0.1, False, 'cpu', time.perf_counter(),"
        " log=lambda m: None)\n"
        "print(json.dumps(harness.forbidden_loaded()))\n") % (str(BENCH / "tests"), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
