"""The torch port as a whole: its CLI against the JAX package's, and its
independence from jax.

`-c --device cpu` writes .xsi bytes identical to the JAX package's
device="numpy" and device="jax" runs; `-x` gives identical records."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from xsqueezeit_tpu.codec.compressor import CompressorOptions, compress_file
from xsqueezeit_tpu_torch.cli import main as torch_cli
from tests import fixtures
from tests.test_e2e import read_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    return fixtures.random_vcf(str(d / "in.vcf"), n_samples=64,
                               n_records=200, seed=42)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_compress_matches_jax_package(vcf, tmp_path):
    out = str(tmp_path / "t.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", out, "--device", "cpu",
                      "--variant-block-length", "64", "--maf", "0.01"]) == 0
    for device in ("numpy", "jax"):
        ref = str(tmp_path / f"{device}.xsi")
        compress_file(vcf, ref, CompressorOptions(device=device,
                                                  block_length=64, maf=0.01))
        assert _read(out) == _read(ref), device


@pytest.mark.parametrize("extra", [[], ["--zstd", "--wah-encode-missing"]])
def test_compress_devices_identical(tmp_path, extra):
    vcf = fixtures.micro_missing(str(tmp_path / "m.vcf"))
    outs = []
    for device in ("cpu", "numpy"):
        out = str(tmp_path / f"{device}.xsi")
        assert torch_cli(["-c", "-f", vcf, "-o", out, "--device", device,
                          "--variant-block-length", "2", *extra]) == 0
        outs.append(_read(out))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("args", [
    [],
    ["-r", "20:60200-61500"],
    ["-t", "20:60000-62000"],
    ["-s", "S001,S005,S063"],
    ["-O", "z"],
])
def test_extract_matches_numpy(vcf, tmp_path, args):
    xsi = str(tmp_path / "x.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", "cpu",
                      "--variant-block-length", "64", "--maf", "0.01"]) == 0
    ext = ".vcf.gz" if args[:2] == ["-O", "z"] else ".vcf"
    got, want = str(tmp_path / f"c{ext}"), str(tmp_path / f"n{ext}")
    assert torch_cli(["-x", "-f", xsi, "-o", got, "--device", "cpu",
                      *args]) == 0
    assert torch_cli(["-x", "-f", xsi, "-o", want, "--device", "numpy",
                      *args]) == 0
    g, _ = read_all(got)
    w, _ = read_all(want)
    assert g == w and len(g) > 0
    if not args:
        assert g == read_all(vcf)[0]


def test_bcf_output_roundtrip(vcf, tmp_path):
    xsi = str(tmp_path / "b.xsi")
    out = str(tmp_path / "b.bcf")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", "cpu"]) == 0
    assert torch_cli(["-x", "-f", xsi, "-o", out, "--device", "cpu"]) == 0
    assert read_all(out)[0] == read_all(vcf)[0]


def test_info(vcf, tmp_path, capsys):
    xsi = str(tmp_path / "i.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", "numpy"]) == 0
    assert torch_cli(["-i", "-f", xsi]) == 0
    assert capsys.readouterr().err.strip()


def test_cuda_without_card_is_a_one_line_error(vcf, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert torch_cli(["-c", "-f", vcf, "-o", str(tmp_path / "c.xsi"),
                      "--device", "cuda"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]
    assert not os.path.exists(tmp_path / "c.xsi")


@pytest.mark.parametrize("args", [[], ["-s", "S001,S005,S063"],
                                  ["-r", "20:60200-61500"]])
def test_recompress_needs_numpy_device(vcf, tmp_path, args):
    """-O x, once refused on every device but numpy, re-encodes on the
    port's device: the .xsi and its variant file are byte-identical to
    --device numpy's (and, unfiltered, to the source)."""
    xsi = str(tmp_path / "r.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", "cpu"]) == 0
    outs = []
    for device in ("cpu", "numpy"):
        out = str(tmp_path / device / "o.xsi")   # the name is in the header
        os.makedirs(os.path.dirname(out))
        assert torch_cli(["-x", "-f", xsi, "-o", out, "-O", "x",
                          "--device", device, *args]) == 0
        outs.append((_read(out), _read(out + "_var.bcf")))
    assert outs[0] == outs[1]
    if not args:
        assert outs[0][0] == _read(xsi)


def test_recompress_detour_matches_fused(vcf, tmp_path, monkeypatch):
    xsi = str(tmp_path / "r.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", "cpu",
                      "--variant-block-length", "64"]) == 0
    outs = []
    for fused in ("1", "0"):
        monkeypatch.setenv("XSI_FUSED_RECOMPRESS", fused)
        out = str(tmp_path / fused / "o.xsi")
        os.makedirs(os.path.dirname(out))
        assert torch_cli(["-x", "-f", xsi, "-o", out, "-O", "x",
                          "--device", "cpu", "-s", "^S002"]) == 0
        outs.append(_read(out))
    assert outs[0] == outs[1]


def test_block_of_monomorphic_sites(tmp_path):
    """Two ALT-less records fill a block with no binary line; the port
    used to crash there with a traceback."""
    rows = [(".", ["0|0"] * 10), (".", ["0|0"] * 10),
            ("A", ["0|1"] + ["0|0"] * 9)]
    vcf = fixtures.write_vcf(str(tmp_path / "mono.vcf"), rows)
    outs = []
    for device in ("cpu", "numpy"):
        xsi = str(tmp_path / f"{device}.xsi")
        assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", device,
                          "--variant-block-length", "2"]) == 0
        outs.append(_read(xsi))
    assert outs[0] == outs[1]
    back = str(tmp_path / "back.vcf")
    assert torch_cli(["-x", "-f", str(tmp_path / "cpu.xsi"), "-o", back,
                      "--device", "cpu"]) == 0
    assert read_all(back)[0] == read_all(vcf)[0]


@pytest.mark.parametrize("name", ["micro_mixed_ploidy", "micro_eov",
                                  "micro_missing_non_uniform_phasing_ploidy"])
def test_micro_roundtrip_devices_identical(tmp_path, name):
    vcf = getattr(fixtures, name)(str(tmp_path / f"{name}.vcf"))
    outs = []
    for device in ("cpu", "numpy"):
        xsi = str(tmp_path / f"{device}.xsi")
        assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", device,
                          "--variant-block-length", "2"]) == 0
        outs.append(_read(xsi))
        back = str(tmp_path / f"{device}.vcf")
        assert torch_cli(["-x", "-f", xsi, "-o", back, "--device",
                          device]) == 0
        assert read_all(back)[0] == read_all(vcf)[0]
    assert outs[0] == outs[1]


NO_JAX = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy as np

    class RefuseJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith("jax."):
                raise ImportError("jax is refused in this process")
            return None

    sys.meta_path.insert(0, RefuseJax())
    import xsqueezeit_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        xsqueezeit_tpu_torch.__path__, "xsqueezeit_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from tests.gt_synth import make_record
    from xsqueezeit_tpu_torch.codec.decoder_torch import decode_block_records
    from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
    rng = np.random.default_rng(0)
    blocks = [  # plain; missing/EOV/phase tracks (fused); mixed ploidy
        [make_record(rng, 40, p_alt=p) for p in [0.01, 0.3, 0.99] * 5],
        [make_record(rng, 40, p_alt=p, p_missing=0.05, p_eov=0.05,
                     p_phase_flip=0.1) for p in [0.01, 0.3, 0.99] * 5],
        [make_record(rng, 40, p_alt=p, haploid=i % 2 == 0, p_missing=0.05)
         for i, p in enumerate([0.01, 0.3, 0.99] * 5)],
    ]
    for recs in blocks:
        enc = TorchBlockEncoder(40, 100, 2, device="cpu")
        for gt, na in recs:
            enc.encode_record(gt, na)
        out = decode_block_records(enc.serialize(), 40, 80, np.uint32,
                                   [na for _, na in recs], device="cpu")
        assert all((o == gt).all() for o, (gt, _) in zip(out, recs))
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print("imported", len(names), "modules")
""")


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
