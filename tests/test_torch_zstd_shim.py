"""The port's CLI where the `zstandard` package is missing.

Each case runs the CLI in a subprocess whose `import zstandard` fails
(sys.modules["zstandard"] = None).  The port's container imports the
package only where a zstd block is written or read, so a file without
zstd blocks must compress and extract exactly as with the package;
`--zstd`, or reading a zstd .xsi, must fail with one line that names the
missing package."""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from xsqueezeit_tpu_torch.cli import main as torch_cli
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WITHOUT_ZSTD = textwrap.dedent("""
    import sys
    sys.modules["zstandard"] = None          # import zstandard fails
    from xsqueezeit_tpu_torch.cli import main
    rc = main(sys.argv[1:])
    assert sys.modules["zstandard"] is None  # no stand-in was planted
    sys.exit(rc)
""")


def _cli_without_zstd(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", WITHOUT_ZSTD, *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    d = tmp_path_factory.mktemp("zstd_shim")
    return fixtures.random_vcf(str(d / "in.vcf"), n_samples=40,
                               n_records=120, seed=11)


def test_roundtrip_without_zstandard_matches_normal_run(vcf, tmp_path):
    common = ["--device", "cpu", "--variant-block-length", "50"]
    want_xsi, got_xsi = str(tmp_path / "n.xsi"), str(tmp_path / "s.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", want_xsi, *common]) == 0
    r = _cli_without_zstd("-c", "-f", vcf, "-o", got_xsi, *common)
    assert r.returncode == 0, r.stderr
    assert _read(got_xsi) == _read(want_xsi)

    want_vcf, got_vcf = str(tmp_path / "n.vcf"), str(tmp_path / "s.vcf")
    assert torch_cli(["-x", "-f", want_xsi, "-o", want_vcf,
                      "--device", "cpu"]) == 0
    r = _cli_without_zstd("-x", "-f", got_xsi, "-o", got_vcf,
                          "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert _read(got_vcf) == _read(want_vcf)


def _one_line_error(r):
    assert r.returncode == 1
    err = r.stderr.strip().splitlines()
    assert len(err) == 1, r.stderr
    assert "zstd" in err[0] and "`zstandard` package is not installed" \
        in err[0]


def test_zstd_flag_is_a_one_line_error(vcf, tmp_path):
    out = str(tmp_path / "z.xsi")
    _one_line_error(_cli_without_zstd("-c", "-f", vcf, "-o", out, "--zstd",
                                      "--device", "cpu"))
    assert not os.path.exists(out)


def test_zstd_file_is_a_one_line_error(vcf, tmp_path):
    xsi = str(tmp_path / "z.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--zstd",
                      "--device", "cpu"]) == 0
    out = str(tmp_path / "z.vcf")
    _one_line_error(_cli_without_zstd("-x", "-f", xsi, "-o", out,
                                      "--device", "cpu"))
    assert not os.path.exists(out)
