"""The torch port at HRC width: H = 64,976 haplotypes (32,488 samples).

The same seeded numpy inputs go through the port (CPU tensors, the
kernels' plain versions) and the JAX package (Pallas kernels in interpret
mode, the XLA forms, the host codec).  A block is a few chunks of lines
only, to keep each case short.  Tolerance: exact equality.

This width lies above the one-CTA bounds of both chain kernels (28,928
haplotypes for decode, 57,856 for encode), where the block codec used to
raise NotImplementedError.  Wider blocks (H > 65,535) take other
functions: tests/test_torch_wide.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu.ops import pbwt_jax, pbwt_pallas
from xsqueezeit_tpu.ops.wah_pallas import wah_compress_pallas
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch, wah_kernels
from xsqueezeit_tpu_torch.ops import wah_torch
from tests.gt_synth import make_record

N_SAMPLES = 32488
H = 2 * N_SAMPLES                  # 64,976
MAC = int(H * 0.001)               # 64, the default MAF's threshold
C = 16


def _lines(rng, L, ps=(0.0005, 0.02, 0.3, 0.7, 0.9995)):
    p = rng.choice(ps, size=L)
    return (rng.random((L, H)) < p[:, None]).astype(np.int8)


def test_width_is_above_the_one_cta_bounds():
    assert pbwt_kernels.MAX_H_DECODE < pbwt_kernels.MAX_H_ENCODE < H
    assert H <= pbwt_kernels.SLOT16_H
    assert pbwt_kernels.cluster_size("chain_encode", H) == 8
    assert pbwt_kernels.cluster_size("chain_decode", H) == 16


@pytest.mark.parametrize("name,width,cluster,want", [
    ("chain_encode", 5008, None, 1),
    ("chain_encode", 57856, None, 1),
    ("chain_encode", 57857, None, 8),
    ("chain_decode", 28928, None, 1),
    # the decode on a cluster keeps its rows in device memory, on 16 CTAs
    ("chain_decode", 28929, None, 16),
    ("chain_decode", 57857, None, 16),
    ("chain_decode", 5008, 4, 4),
    ("chain_decode", H, 3, 3),
    ("chain_encode", 3, 8, 8),
])
def test_cluster_size(name, width, cluster, want):
    assert pbwt_kernels.cluster_size(name, width, cluster) == want


@pytest.mark.parametrize("name,width,K,want", [
    # one CTA: the row in whole tiles (256 u16 / 128 u32), double buffered
    ("chain_encode", 1, 1, 2 * 2 * 256),
    ("chain_encode", 57856, 1, 2 * 2 * 57856),
    ("chain_encode", 57857, 1, 2 * 2 * (57856 + 256)),
    ("chain_decode", 28928, 1, 2 * 4 * 28928),
    ("chain_decode", 28929, 1, 2 * 4 * (28928 + 128)),
    # the encode on a cluster: each CTA's share in whole tiles, plus 16
    # warps' staging of two runs (a tile and 16 bytes each); the decode on
    # a cluster keeps both rows in device memory
    ("chain_encode", H, 2, 2 * 2 * 32512 + 16 * 2 * 528),
    ("chain_decode", H, 3, 0),
    ("chain_decode", H, 8, 0),
    ("chain_encode", 3, 8, 2 * 2 * 256 + 16 * 2 * 528),
])
def test_chain_smem_bytes(name, width, K, want):
    got = pbwt_kernels.chain_smem_bytes(name, width, K)
    assert got == want
    assert (got <= pbwt_kernels._SMEM_BYTES) == (
        K > 1 or width <= {"chain_encode": pbwt_kernels.MAX_H_ENCODE,
                           "chain_decode": pbwt_kernels.MAX_H_DECODE}[name])


@pytest.mark.parametrize("name,width,cluster,match", [
    ("chain_decode", 28929, 1, "shared memory"),
    ("chain_encode", H, 1, "shared memory"),
    ("chain_decode", 131073, 2, "device memory"),  # 512 tiles a CTA
    ("chain_decode", 5008, 17, "1 to 16 CTAs"),
    ("chain_decode", 491506, None, "491505"),
    ("chain_encode", 491506, None, "491505"),
])
def test_cluster_size_refusals(name, width, cluster, match):
    with pytest.raises(ValueError, match=match):
        pbwt_kernels.cluster_size(name, width, cluster)


@pytest.mark.parametrize("n_ch", [1, 3])
def test_chain_encode_plain_matches_pallas(n_ch):
    rng = np.random.default_rng(640 + n_ch)
    q0 = rng.integers(0, 1 << C, (n_ch, H), dtype=np.int32)
    ss = rng.random((n_ch, C)) < 0.8
    got = pbwt_kernels.chain_encode(torch.from_numpy(q0),
                                    torch.from_numpy(ss))
    hp = pbwt_pallas._ceil_to(H, pbwt_pallas.LANE)
    q0p = np.zeros((n_ch, hp), np.uint32)
    q0p[:, :H] = q0
    want = np.asarray(pbwt_pallas.chain_encode(
        jnp.asarray(q0p), jnp.asarray(ss.astype(np.int32)), C, H,
        interpret=True))[:, :, :H]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_ch", [1, 3])
def test_chain_decode_plain_matches_pallas(n_ch):
    rng = np.random.default_rng(650 + n_ch)
    y = _lines(rng, n_ch * C).astype(np.uint8).reshape(n_ch, C, H)
    ss = rng.random((n_ch, C)) < 0.8
    got = pbwt_kernels.chain_decode(torch.from_numpy(y), torch.from_numpy(ss))
    hp = pbwt_pallas._ceil_to(H, pbwt_pallas.LANE)
    yp = np.zeros((n_ch, C, hp), np.int32)
    yp[:, :, :H] = y
    want = np.asarray(pbwt_pallas.chain_decode(
        jnp.asarray(yp), jnp.asarray(ss.astype(np.int32)), C, H,
        interpret=True))[:, -1, :H]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("L", [48, 37])
def test_chunked_encode_decode_match_jax(L):
    rng = np.random.default_rng(660 + L)
    x = _lines(rng, L)
    alts = np.ones(L, np.int32)
    sorts = rng.random(L) < 0.85
    ys, a_fin = pbwt_torch.pbwt_encode_chunked(
        torch.from_numpy(x), torch.from_numpy(alts), torch.from_numpy(sorts))
    want_y, want_a = pbwt_jax.pbwt_encode_chunked(
        jnp.asarray(x), jnp.asarray(alts), jnp.asarray(sorts))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(a_fin.numpy(), np.asarray(want_a))

    vals, a_dec = pbwt_torch.pbwt_decode_chunked(ys, torch.from_numpy(sorts))
    jv, ja = pbwt_jax.pbwt_decode_chunked(want_y, jnp.asarray(sorts))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(vals.numpy(), (x == 1).astype(np.uint8))
    np.testing.assert_array_equal(a_dec.numpy(), np.asarray(ja))


def test_wah_compress_plain_matches_pallas_at_hrc_width():
    rng = np.random.default_rng(670)
    bits = torch.from_numpy(_lines(rng, 24).astype(np.uint8))
    words = wah_torch.pack_bits(bits)
    assert words.shape[1] == 4332
    got_w, got_n = wah_kernels.wah_compress(words)
    jw = jnp.asarray(words.numpy())
    want_w, want_n = wah_compress_pallas(jw, jw.shape[1], interpret=True)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_w.numpy().astype(np.int64),
                                  np.asarray(want_w).astype(np.int64))


def _records(seed, n=48, phased=True):
    """A short HRC block: rare (sparse), near-fixed (negated sparse) and
    common (PBWT + WAH) biallelic records, plus one multi-allelic one."""
    rng = np.random.default_rng(seed)
    ps = [0.0004, 0.3, 0.9996, 0.05, 0.6, 0.002]
    recs = [make_record(rng, N_SAMPLES, p_alt=ps[i % len(ps)], phased=phased)
            for i in range(n - 1)]
    recs.insert(n // 2, make_record(rng, N_SAMPLES, n_alts=2, p_alt=0.4,
                                    phased=phased))
    return recs


def _kw(phased):
    return dict(n_samples=N_SAMPLES, block_bcf_lines=10_000,
                mac_threshold=MAC, default_phasing=int(phased),
                aet_dtype=np.uint16)


@pytest.mark.parametrize("phased", [True, False])
def test_block_encoder_matches_host_encoder(phased):
    recs = _records(680 + phased, phased=phased)
    ref = GtBlockEncoder(**_kw(phased))
    enc = TorchBlockEncoder(device="cpu", **_kw(phased))
    for gt, na in recs:
        ref.encode_record(gt, na)
        enc.encode_record(gt, na)
    assert enc.serialize() == ref.serialize()


def test_block_decoder_matches_host_decoder():
    recs = _records(690)
    ref = GtBlockEncoder(**_kw(True))
    for gt, na in recs:
        ref.encode_record(gt, na)
    payload = ref.serialize()
    nas = [na for _, na in recs]

    dec = decoder_torch.TorchBlockDecoder(payload, N_SAMPLES, H, np.uint16,
                                          device="cpu")
    assert dec.eligible
    got = decoder_torch.decode_block_records(payload, N_SAMPLES, H,
                                             np.uint16, nas, device="cpu")
    host = GtBlockDecoder(payload, N_SAMPLES, H, np.uint16)
    for i, na in enumerate(nas):
        want = host.fill_genotype_array_advance(na)
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], recs[i][0])


def test_wider_than_16_bits_is_refused():
    """H = 65,536, one past the chunk chains' 16-bit slot field, was once
    refused; it now takes the scan and the blocked decode (32-bit sparse
    and track streams) and round-trips byte for byte with the host
    codec."""
    n = 32768                      # H = 65,536
    rng = np.random.default_rng(700)
    kw = dict(n_samples=n, block_bcf_lines=10_000, mac_threshold=65,
              default_phasing=1, aet_dtype=np.uint32)
    enc = TorchBlockEncoder(device="cpu", **kw)
    ref = GtBlockEncoder(**kw)
    recs = [make_record(rng, n, p_alt=p, p_missing=0.002)
            for p in (0.3, 0.0005, 0.9995)]
    for gt, na in recs:
        enc.encode_record(gt, na)
        ref.encode_record(gt, na)
    payload = enc.serialize()
    assert payload == ref.serialize()
    got = decoder_torch.decode_block_records(payload, n, 2 * n, np.uint32,
                                             [2] * 3, device="cpu")
    for g, (gt, _) in zip(got, recs):
        np.testing.assert_array_equal(g, gt)
