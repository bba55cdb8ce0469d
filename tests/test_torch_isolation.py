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


AUDITED = textwrap.dedent("""
    import os, sys

    REPO, BCF, WORK = sys.argv[1:4]
    events = []

    def hook(event, args):
        if event in ("open", "ctypes.dlopen", "subprocess.Popen"):
            events.append((event, args))

    sys.addaudithook(hook)
    FORBIDDEN = ("jax", "jaxlib", "xsqueezeit_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"{name} is refused in this process")
            return None

    sys.meta_path.insert(0, Refuse())
    from xsqueezeit_tpu_torch.bench.__main__ import main as bench_main
    from xsqueezeit_tpu_torch.cli import main
    from xsqueezeit_tpu_torch.interop import native

    native.build_c_api(force=True)     # a build this process surely runs
    for device in ("cpu", "numpy"):
        xsi = os.path.join(WORK, device + ".xsi")
        assert main(["-c", "-f", BCF, "-o", xsi, "--device", device,
                     "--variant-block-length", "40"]) == 0
        for out in ("o.vcf", "o.bcf"):
            assert main(["-x", "-f", xsi, "-o",
                         os.path.join(WORK, device + out),
                         "--device", device]) == 0
    assert bench_main(["loading_time", xsi, "--native"]) == 0
    build = os.path.join(REPO, "xsqueezeit_tpu_torch", "build")
    src = os.path.join(REPO, "xsqueezeit_tpu_torch", "native")
    jax_native = os.path.join(REPO, "native")
    loaded = [str(a[0]) for e, a in events if e == "ctypes.dlopen"
              and "xsqueezeit" in str(a[0])]
    assert loaded and all(p.startswith(build + os.sep) for p in loaded), \\
        loaded
    opened = [str(a[0]) for e, a in events if e == "open"]
    assert not [p for p in opened if p.startswith(jax_native + os.sep)]
    runs = [list(map(str, a[1])) for e, a in events
            if e == "subprocess.Popen"]
    compiles = [r for r in runs if any(x.endswith(".cpp") for x in r)]
    assert compiles, runs
    assert not [r for r in runs if os.path.basename(r[0]) == "make"]
    for r in compiles:
        for x in r:
            assert not x.startswith(jax_native + os.sep), r
            if x.endswith(".cpp"):
                assert x.startswith(src + os.sep), r
            if x.endswith(".so") or ".so." in x:
                assert x.startswith(build + os.sep), r
    print("loaded", sorted(set(loaded)))
""")


def test_native_library_builds_and_loads_only_from_the_port(tmp_path):
    """With the JAX package refused, the port builds its native libraries
    from xsqueezeit_tpu_torch/native/ into xsqueezeit_tpu_torch/build/ and
    loads them only from there (CLI -c / -x on cpu and numpy, a BCF input,
    and loading_time --native); it never opens the JAX package's native/
    directory nor runs make."""
    pytest.importorskip("torch")
    from xsqueezeit_tpu_torch.bench.synth import synth_bcf

    bcf = str(tmp_path / "in.bcf")
    synth_bcf(bcf, 90, 30, seed=8)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", AUDITED, REPO, bcf,
                        str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "libxsqueezeit_tpu.so" in r.stdout
