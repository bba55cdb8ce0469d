"""The mixed-ploidy encode on the chunk chains, on CPU tensors (every
kernel wrapper takes its plain version there).

A mixed block's encode carries each haplotype's slot parity h & 1 in bit
15 of its 16-bit register, in chunks of 15 lines, and the encode chain
emits it beside each line's bit (pbwt_encode_chunked(..., parity=True),
chain_encode(..., parity=True)).  Held against the JAX package's
pbwt_jax.pbwt_encode_scan_parity and the NumPy oracle
pbwt_np.pbwt_encode_parity on the same seeded inputs, at H = 6 to 70,002
(the wide cases a few dozen lines), with lines that do not sort and L
not a multiple of 15; the mixed payloads against GtBlockEncoder's and
the JAX package's DeviceBlockEncoder's, the encode chain seen to run
with the parity payload.  The CUDA routes are held against these plain
versions on the card in tests/test_torch_cuda.py and chip_smoke.py.
Tolerance: exact equality (bits, permutations, bytes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec.encoder_jax import DeviceBlockEncoder
from xsqueezeit_tpu.ops import pbwt_jax, pbwt_np
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch
from tests.gt_synth import make_record


def _mixed_alleles(rng, L, H):
    """Allele codes of L lines, haploid lines slot-duplicated (H even), a
    mix of rare and common lines."""
    p = rng.choice([0.0005, 0.02, 0.3, 0.7, 0.9995], (L, 1))
    alleles = ((rng.random((L, H)) < p).astype(np.int16)
               + (rng.random((L, H)) < 0.05))
    if H % 2 == 0:
        hap = rng.random(L) < 0.5
        alleles[hap] = np.repeat(alleles[hap][:, 0::2], 2, axis=1)
    return alleles


def _sorts(rng, L, kind):
    return {"all": np.ones(L, bool), "none": np.zeros(L, bool),
            "some": rng.random(L) < 0.7}[kind]


#: (H, L, sort flags): L a multiple of the chunk's 15 lines or not, and
#: widths across the encode's routes (one CTA; a cluster of 8 above
#: 57,856) and the format's 16-bit slot field (65,535).
CASES = [(6, 1, "all"), (130, 47, "some"), (2466, 30, "all"),
         (2466, 44, "none"), (65600, 31, "some"), (70002, 30, "all"),
         (70002, 16, "some")]


@pytest.mark.parametrize("H,L,kind", CASES)
def test_parity_chunked_encode_matches_jax_and_numpy(H, L, kind):
    rng = np.random.default_rng(H + L)
    alleles = _mixed_alleles(rng, L, H)
    alts = rng.integers(1, 3, L).astype(np.int32)
    sorts = _sorts(rng, L, kind)
    args = (torch.from_numpy(alleles), torch.from_numpy(alts),
            torch.from_numpy(sorts))
    got = pbwt_torch.pbwt_encode_chunked(*args, parity=True)
    assert [g.dtype for g in got] == [torch.uint8, torch.uint8, torch.int64]
    assert got[0].shape == got[1].shape == (L, H)
    got = [g.numpy() for g in got]
    jax_out = pbwt_jax.pbwt_encode_scan_parity(
        jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
        jnp.arange(H, dtype=jnp.int32))
    oracle = pbwt_np.pbwt_encode_parity(alleles, alts, sorts)
    for want in (jax_out, oracle):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    # the uniform encode of the same lines: the same bits, 16 lines a chunk
    ys, a_fin = pbwt_torch.pbwt_encode_chunked(*args)
    np.testing.assert_array_equal(ys.numpy(), got[0])
    np.testing.assert_array_equal(a_fin.numpy(), got[2])


def _partitioned_registers(q0, ss):
    """Per chunk, the registers at each slot before each line, the slots
    stably partitioned by every sorting line's bit (pbwt_np)."""
    n_ch, C = ss.shape
    out = np.empty((n_ch, C, q0.shape[1]), np.int64)
    for t in range(n_ch):
        a = np.arange(q0.shape[1])
        for j in range(C):
            out[t, j] = q0[t, a]
            if ss[t, j]:
                a = pbwt_np.stable_partition(a, (q0[t, a] >> j) & 1)
    return out


@pytest.mark.parametrize("n_ch,C,H", [(1, 15, 1), (3, 15, 33), (4, 7, 513),
                                      (2, 15, 2466), (2, 1, 40)])
def test_chain_encode_plain_carries_bit_15(n_ch, C, H):
    rng = np.random.default_rng(n_ch * 100 + C + H)
    q0 = rng.integers(0, 1 << 16, (n_ch, H), dtype=np.int32)
    ss = rng.random((n_ch, C)) < 0.8
    args = (torch.from_numpy(q0), torch.from_numpy(ss))
    y = pbwt_kernels.chain_encode(*args, parity=True).numpy()
    assert y.max() <= 3
    np.testing.assert_array_equal(
        y & 1, pbwt_kernels.chain_encode(*args).numpy())
    np.testing.assert_array_equal(
        y & 1, pbwt_kernels.chain_encode_plain(*args).numpy())
    regs = _partitioned_registers(q0, ss)
    np.testing.assert_array_equal(y >> 1, (regs >> 15) & 1)
    np.testing.assert_array_equal(y & 1, (regs >> np.arange(C)[:, None])
                                  & 1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_chain_encode_refuses_parity_with_16_lines(device):
    q0 = torch.zeros((2, 40), dtype=torch.int32, device=device)
    ss = torch.ones((2, 16), dtype=torch.bool, device=device)
    with pytest.raises(ValueError, match="at most 15 lines"):
        pbwt_kernels.chain_encode(q0, ss, parity=True)
    assert pbwt_kernels.PARITY_CHUNK == 15


@pytest.mark.parametrize("H,K,route", [
    (2466, 1, "chain_encode_parity"),             # chrX-males-PAR
    (57856, 1, "chain_encode_parity"),
    (57857, 8, "chain_encode_parity_cluster"),
    (97256, 8, "chain_encode_parity_cluster"),    # TOPMed-males-PAR
    (491504, 16, "chain_encode_parity_cluster"),
])
def test_parity_routes_by_width(H, K, route):
    assert pbwt_kernels.cluster_size("chain_encode", H) == K
    assert pbwt_kernels.chain_route("chain_encode_parity", K) == route
    assert route in pbwt_kernels.launches


def test_topmed_males_par_decode_routes():
    """The TOPMed-males-PAR block's decode (48,628 males, WAH lines in a
    diploid run then a haploid one): both runs on the chains' rows route,
    the diploid run's flush on a cluster (97,256 slots), the haploid run's
    on one CTA (48,628); what chip_smoke.py's PATH_KERNELS lists."""
    H, N = 97256, 48628
    hap = np.arange(4400) >= 2500
    assert [r for *_, r in pbwt_torch.mixed_runs(hap, H)] \
        == ["diploid", "haploid"]
    for W, flush in ((H, 8), (N, 1)):
        assert pbwt_kernels.cluster_size("chain_decode", W) == 16
        assert pbwt_kernels.flush_cluster(W) == flush
    assert pbwt_kernels.decode_chunk(H) == 15
    assert pbwt_kernels.decode_chunk(N) == 16


def _records(rng, n_samples, L):
    recs = []
    for i in range(L):
        kw = {"p_alt": [0.0005, 0.2, 0.5, 0.03, 0.9][i % 5],
              "haploid": (i // 6) % 2 == 1}
        recs.append(make_record(rng, n_samples, **kw))
    return recs


@pytest.mark.parametrize("n_samples,L", [(1233, 40), (32800, 24)])
def test_mixed_block_codec_takes_the_parity_chains(n_samples, L,
                                                   monkeypatch):
    """A mixed block through TorchBlockEncoder on the CPU: the payload
    equals GtBlockEncoder's and the JAX package's DeviceBlockEncoder's;
    the encode chain ran once, with the parity payload and 15 lines a
    chunk."""
    H = 2 * n_samples
    recs = _records(np.random.default_rng(n_samples), n_samples, L)
    kw = dict(n_samples=n_samples, block_bcf_lines=10_000,
              mac_threshold=max(2, H // 1000), default_phasing=1,
              aet_dtype=np.uint16 if H <= 65535 else np.uint32)
    payloads = []
    for cls in (GtBlockEncoder, DeviceBlockEncoder):
        enc = cls(**kw)
        for gt, na in recs:
            enc.encode_record(gt, na)
        payloads.append(enc.serialize())

    calls = []
    chain = pbwt_kernels.chain_encode

    def spy(q0, ss, *a, **k):
        calls.append((tuple(q0.shape), ss.shape[1], k.get("parity")))
        return chain(q0, ss, *a, **k)
    monkeypatch.setattr(pbwt_kernels, "chain_encode", spy)
    enc = TorchBlockEncoder(device="cpu", **kw)
    for gt, na in recs:
        enc.encode_record(gt, na)
    payload = enc.serialize()
    assert payload == payloads[0]
    assert payload == payloads[1]
    ((n_ch, width), C, parity), = calls
    assert (width, C, parity) == (H, 15, True)
    got = decoder_torch.decode_block_records(
        payload, n_samples, H, kw["aet_dtype"], [na for _, na in recs],
        device="cpu")
    for g, (gt, _) in zip(got, recs):
        np.testing.assert_array_equal(g, gt)
