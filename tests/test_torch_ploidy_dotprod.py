"""dot_prod over a males-chrX file on the port's CPU device: a block across
PAR1's end (diploid lines, then haploid ones) takes the mixed decode route
and the mixed product, the next block, all haploid, the uniformly haploid
route at H = n_samples.  Two cuts of the benchmark's
topmed-r2-chrx-males configuration, ~300 records in blocks of 256, widths
not multiples of 16: 300 males (16-bit streams) and 32,801 males (65,602
slots in the diploid run: 32-bit streams, the wide chains).  The file is
drawn by the benchmark's generator and compressed by the port's `-c` on
`cpu`; every dot is held to the benchmark's float64 reference
(benchmark/reference/ploidy_dots.py) and to the host walk over the
compressed forms.  Card cases: tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.reference import dots as ref_dots
from benchmark.reference import ploidy_dots
from xsqueezeit_tpu_torch.bench import tools
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.utils import trace
from tests import fixtures

#: Records, records a block, and records in PAR1: block 0 holds 128
#: diploid lines then 128 haploid ones, block 1 the last 44 (haploid).
N_RECORDS, BLOCK, PAR_RECORDS = 300, 256, 128
SEED = 2**31 + 17
#: dot_prod's phenotype seed.
PHEN = 23
#: A dot's widest gap over max(|its float64 dot|, 1): float32 sums of up
#: to 65,602 weights in [0, 1) stay within a few 1e-7 of float64.
RTOL = 1e-6


@pytest.fixture(scope="module", params=[300, 32801], ids=["narrow", "wide"])
def males(request, tmp_path_factory):
    """(configuration, .xsi the port's -c wrote on cpu) of one cut."""
    n = request.param
    td = tmp_path_factory.mktemp(f"males{n}")
    cfg = fixtures.males_chrx_config(n, N_RECORDS, PAR_RECORDS)
    bcf = fixtures.males_chrx_bcf(str(td / "in.bcf"), cfg, SEED)
    xsi = str(td / "o.xsi")
    assert torch_cli(["-c", "-f", bcf, "-o", xsi, "--device", "cpu",
                      "--variant-block-length", str(BLOCK),
                      "--maf", str(cfg["maf"])]) == 0
    return cfg, xsi


@pytest.fixture
def tracing():
    trace.collect()
    trace.enable()
    yield
    trace.disable()
    trace.collect()


def test_cut_has_the_shapes_it_names(males):
    """Widths off the product's 16-byte loads; 32-bit streams at the wide
    cut; the first PAR_RECORDS records diploid, the rest haploid."""
    from benchmark.harness import gen_ploidy
    from xsqueezeit_tpu_torch.accessor import Accessor
    cfg, xsi = males
    n = cfg["samples"]
    assert (2 * n) % 16 and n % 16
    acc = Accessor(xsi)
    assert acc.xsi.aet_dtype == (np.uint32 if 2 * n > 0xFFFF else np.uint16)
    dip = gen_ploidy.diploid(cfg)
    assert dip[:PAR_RECORDS].all() and not dip[PAR_RECORDS:].any()


def test_dots_match_float64_and_the_host_walk(males):
    cfg, xsi = males
    got = tools.dot_prod(xsi, seed=PHEN, device="cpu")
    host = tools.dot_prod(xsi, seed=PHEN, device="host")
    want = ploidy_dots.dots(cfg, SEED, PHEN, "cpu")
    assert got["variants"] == host["variants"] == N_RECORDS
    assert ref_dots.rel_err(got["dots"], want) <= RTOL
    assert ref_dots.rel_err(got["dots"], host["dots"]) <= RTOL
    # the host walk sums the same weights in float64
    assert ref_dots.rel_err(host["dots"], want) <= 1e-12


def test_blocks_take_the_mixed_and_haploid_routes(males, tracing):
    cfg, xsi = males
    n = cfg["samples"]
    got = tools.dot_prod(xsi, seed=PHEN, device="cpu")
    assert (got["mixed_blocks"], got["haploid_blocks"], got["device_blocks"],
            got["host_blocks"]) == (1, 1, 1, 0)
    spans = trace.collect()["spans"]
    blocks = [s.attrs["route"] for s in spans if s.name == "dot_prod.block"]
    assert blocks == ["mixed", "device"]
    products = [s.attrs for s in spans if s.name == "dot_prod.product"]
    assert [(p["mode"], p["width"], p["rows"]) for p in products] == [
        ("mixed", 2 * n, BLOCK), ("haploid", n, N_RECORDS - BLOCK)]
    assert all(p["samples"] == n and p["loads"] == 1 for p in products)
    mixed = [s for s in spans if s.name == "decode.mixed"]
    assert [(s.attrs["haps"], s.attrs["lines"], s.attrs["haploid_lines"])
            for s in mixed] == [(2 * n, BLOCK, BLOCK - PAR_RECORDS)]
    counts = [s.counts.get("decode.haploid_lines") for s in spans
              if s.name == "decode.device"]
    assert counts == [BLOCK - PAR_RECORDS, N_RECORDS - BLOCK]
