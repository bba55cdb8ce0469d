"""The port stands alone: nothing under xsqueezeit_tpu_torch/ and nothing
in chip_smoke.py imports jax, jaxlib or any module of the JAX package
(xsqueezeit_tpu), directly or through a relative import.

First a static scan of every source file's imports; then a subprocess
that refuses those packages at import time, imports every module of the
port and runs its CLI (-c and -x on the CPU) and two of its tools
(loading_time, dot_prod --device cpu) on a small file."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

from tests import fixtures
from tests.test_e2e import read_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "xsqueezeit_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "xsqueezeit_tpu")


def _sources() -> list[str]:
    out = ["chip_smoke.py"]
    for root, _, files in os.walk(os.path.join(REPO, PORT)):
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _imports(rel: str) -> list[str]:
    """Absolute names of every module `rel` imports (relative imports
    resolved against the file's package)."""
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    package = rel[:-3].split(os.sep)[:-1]    # a module's or __init__'s
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                up = node.level - 1
                if up > len(package):
                    names.append("<import above the top-level package>")
                    continue
                parts = package[:len(package) - up]
                base = ".".join(parts + ([node.module] if node.module
                                         else []))
            names += [base] + [f"{base}.{a.name}" for a in node.names]
    return names


def test_the_scan_resolves_relative_imports():
    assert _forbidden("xsqueezeit_tpu.codec.gt_block")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("xsqueezeit_tpu_torch.codec.gt_block")
    got = _imports(os.path.join(PORT, "codec", "compressor.py"))
    assert "xsqueezeit_tpu_torch.format.container" in got


@pytest.mark.parametrize("rel", _sources())
def test_no_import_of_jax_or_the_jax_package(rel):
    bad = [n for n in _imports(rel)
           if _forbidden(n) or n.startswith("<")]
    assert not bad, f"{rel} imports {bad}"


REFUSING = textwrap.dedent("""
    import importlib, pkgutil, sys

    FORBIDDEN = ("jax", "jaxlib", "xsqueezeit_tpu")
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            del sys.modules[name]

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"{name} is refused in this process")
            return None

    sys.meta_path.insert(0, Refuse())
    import xsqueezeit_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        xsqueezeit_tpu_torch.__path__, "xsqueezeit_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from xsqueezeit_tpu_torch.cli import main
    vcf, xsi, out = sys.argv[1:4]
    assert main(["-c", "-f", vcf, "-o", xsi, "--device", "cpu",
                 "--variant-block-length", "40"]) == 0
    assert main(["-x", "-f", xsi, "-o", out, "--device", "cpu"]) == 0
    from xsqueezeit_tpu_torch.bench.__main__ import main as bench_main
    assert bench_main(["loading_time", xsi]) == 0
    assert bench_main(["dot_prod", xsi, "--device", "cpu"]) == 0
    assert not [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
    print("imported", len(names), "modules")
""")


def test_port_runs_with_jax_and_the_jax_package_refused(tmp_path):
    pytest.importorskip("torch")
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=30,
                              n_records=90, seed=8)
    xsi, out = str(tmp_path / "o.xsi"), str(tmp_path / "o.vcf")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", REFUSING, vcf, xsi, out],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
    assert read_all(out)[0] == read_all(vcf)[0]
