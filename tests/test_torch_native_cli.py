"""The port's CLI with its native routes on and off (XSI_NATIVE=0,
XSI_NATIVE_PARSE=0, XSI_NATIVE_ENCODE=0), on `cpu` tensors and on the host
codec (`numpy`), against `python -m xsqueezeit_tpu.cli` on
tests/test_torch_parity.py's fixtures, as VCF and as BCF input: the
.xsi, _var.bcf and .csi of -c, and the files of -x to VCF, BCF and XSI
and to BCF with a region and with a target, byte for byte.  The emitter
runs in its zlib mode (XSI_EMIT_ZLIB=1), so its bytes are the Python
writer's; in the default libdeflate mode the records are equal.  A compiler that fails makes -c exit 1 with its
message, and XSI_NATIVE=0 then still compresses.  Tolerance: exact
equality."""
import os

import pytest

pytest.importorskip("torch")

from xsqueezeit_tpu import cli as jax_cli
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.interop import native
from xsqueezeit_tpu_torch.io.bcf import BcfReader
from tests.test_torch_native import vcf_to_bcf
from tests.test_torch_parity import FIXTURES
from tests.jax_build import jax_native_built  # noqa: F401 (autouse)

#: name -> the environment of a route set
ROUTES = {
    "native": {},
    "off": {"XSI_NATIVE": "0"},
    "parse_off": {"XSI_NATIVE_PARSE": "0"},
    "encode_off": {"XSI_NATIVE_ENCODE": "0"},
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _records(path):
    r = BcfReader(path)
    out = [(bytes(rec.shared), bytes(rec.indiv)) for rec in r]
    r.close()
    return out


#: the -x runs: (output type, file, extra arguments)
EXTRACTS = (("v", "o.vcf", ()), ("b", "o.bcf", ()), ("x", "re.xsi", ()),
            ("b", "r.bcf", ("-r", "20:60003-60040")),
            ("b", "t.bcf", ("-t", "20:60010-60090")))


def _jax(d, src, block):
    """The JAX package's files in `d` (its host codec: tests/conftest.py
    pins XSI_DEVICE=numpy): -c, then -x to VCF, BCF and XSI, and to BCF
    with a region and with a target.  None when it refuses the input."""
    d.mkdir(parents=True)
    xsi = str(d / "o.xsi")
    if jax_cli.main(["-c", "-f", src, "-o", xsi,
                     "--variant-block-length", str(block)]) != 0:
        return None
    for ot, name, extra in EXTRACTS:
        assert jax_cli.main(["-x", "-f", xsi, "-o", str(d / name),
                             "-O", ot, *extra]) == 0
    return d


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cli_files_match_jax(name, route, tmp_path, monkeypatch):
    monkeypatch.setenv("XSI_EMIT_ZLIB", "1")
    write, block = FIXTURES[name]
    vcf = write(str(tmp_path / "in.vcf"))
    for fmt in ("vcf", "bcf"):
        src = vcf if fmt == "vcf" else vcf_to_bcf(vcf, str(tmp_path /
                                                          "in.bcf"))
        want = _jax(tmp_path / fmt / "jax", src, block)
        for k, v in ROUTES[route].items():
            monkeypatch.setenv(k, v)
        for device in ("cpu", "numpy"):
            d = tmp_path / fmt / device
            d.mkdir()
            xsi = str(d / "o.xsi")
            rc = torch_cli(["-c", "-f", src, "-o", xsi, "--device", device,
                            "--variant-block-length", str(block)])
            if want is None:            # both CLIs refuse the input
                assert rc == 1
                continue
            assert rc == 0
            for sfx in ("", "_var.bcf", "_var.bcf.csi"):
                assert _read(xsi + sfx) == _read(str(want / "o.xsi") + sfx), \
                    (fmt, device, sfx)
            for ot, out, extra in EXTRACTS:
                assert torch_cli(["-x", "-f", xsi, "-o", str(d / out),
                                  "-O", ot, "--device", device, *extra]) == 0
                assert _read(str(d / out)) == _read(str(want / out)), \
                    (fmt, device, out)
        for k in ROUTES[route]:
            monkeypatch.delenv(k)


def test_libdeflate_mode_writes_the_same_records(tmp_path, monkeypatch):
    """Without XSI_EMIT_ZLIB the native variant pass and extract loop
    deflate with libdeflate where the build found it: other BGZF bytes,
    the same records, and the .xsi is unchanged."""
    monkeypatch.delenv("XSI_EMIT_ZLIB", raising=False)
    write, block = FIXTURES["random"]
    bcf = vcf_to_bcf(write(str(tmp_path / "in.vcf")),
                     str(tmp_path / "in.bcf"))
    outs = {}
    for route in ("native", "off"):
        monkeypatch.setenv("XSI_NATIVE", "0" if route == "off" else "1")
        d = tmp_path / route
        d.mkdir()
        xsi = str(d / "o.xsi")
        assert torch_cli(["-c", "-f", bcf, "-o", xsi, "--device", "numpy",
                          "--variant-block-length", str(block)]) == 0
        assert torch_cli(["-x", "-f", xsi, "-o", str(d / "o.bcf"),
                          "--device", "numpy"]) == 0
        outs[route] = (_read(xsi), _records(xsi + "_var.bcf"),
                       _records(str(d / "o.bcf")))
    assert outs["native"] == outs["off"]


def test_a_failing_compiler_fails_the_cli(tmp_path, monkeypatch, capsys):
    """With the library not built and g++ failing, -c of a BCF exits 1
    with the compiler's message (no silent Python route); XSI_NATIVE=0
    compresses without the library."""
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/sh\necho 'fatal error: zlib.h: No such file' "
                   ">&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    write, block = FIXTURES["random"]
    bcf = vcf_to_bcf(write(str(tmp_path / "in.vcf")),
                     str(tmp_path / "in.bcf"))
    for device in ("cpu", "numpy"):
        xsi = str(tmp_path / f"{device}.xsi")
        assert torch_cli(["-c", "-f", bcf, "-o", xsi,
                          "--device", device]) == 1
        err = capsys.readouterr().err
        assert "zlib.h: No such file" in err and "failed" in err
        assert not os.path.exists(xsi)
    monkeypatch.setenv("XSI_NATIVE", "0")
    assert torch_cli(["-c", "-f", bcf, "-o", str(tmp_path / "py.xsi"),
                      "--device", "numpy"]) == 0
    assert torch_cli(["-x", "-f", str(tmp_path / "py.xsi"),
                      "-o", str(tmp_path / "py.vcf"),
                      "--device", "numpy"]) == 0
