"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under benchmark/, and nothing of the program in its reference.
Top-level module names are compared whole: the port's name,
xsqueezeit_tpu_torch, begins with the JAX package's."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX_SIDE = {"jax", "jaxlib", "flax", "xsqueezeit_tpu", "bench"}
PROGRAM = "xsqueezeit_tpu_torch"


def imported_top_levels(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def python_files(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_the_jax_side():
    for path in python_files(BENCH):
        found = imported_top_levels(path) & JAX_SIDE
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in python_files(os.path.join(BENCH, "reference")):
        assert PROGRAM not in imported_top_levels(path), path


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.readback, benchmark.reference.dots\n"
            "bad = sorted({n.split('.')[0] for n in sys.modules}\n"
            "             & {'jax', 'jaxlib', 'flax', 'xsqueezeit_tpu',\n"
            "                'xsqueezeit_tpu_torch'})\n"
            "print(bad)\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_guard_compares_whole_top_level_names():
    from benchmark.harness import guard
    assert guard.forbidden({"xsqueezeit_tpu_torch.cli": 1,
                            "xsqueezeit_tpu_torch": 1}) == []
    assert guard.forbidden({"xsqueezeit_tpu.cli": 1}) == ["xsqueezeit_tpu"]
    assert guard.forbidden({"jax.numpy": 1, "jaxlib": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib"]
    assert guard.forbidden({"jaxtyping": 1}) == []
