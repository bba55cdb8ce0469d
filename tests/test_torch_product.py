"""The block's dot product (ops/product_kernels.py): the wrapper on CPU
tensors takes the plain version, held against float64 dots of the same
float32 weights and against the JAX package's product
(`v.astype(jnp.float32) @ y2`, bench/tools.py) on the same plane, in the
three weight modes, with kept lines in order, out of order with repeats,
and none; then the wrapper's refusals.  Tolerance: relative 1e-6 of each
dot against float64 and against the JAX package's float32 product (float32
sums of at most a few thousand terms, each a weight in [0, 1))."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu_torch.ops import product_kernels

RTOL = 1e-6


def _weights(y, H, mode, haploid_line):
    """float64 weights of a line of width H: y[h] on a haploid block,
    y[h >> 1] otherwise, odd slots 0 on a mixed block's haploid line."""
    h = np.arange(H)
    w = y.astype(np.float64)[h if mode == "haploid" else h >> 1]
    if haploid_line:
        w[1::2] = 0
    return w


def _case(seed, L, H, mode, keep_kind):
    rng = np.random.default_rng(seed)
    vals = (rng.random((L, H)) < rng.choice([0.01, 0.3, 0.9], (L, 1))
            ).astype(np.uint8)
    n = H if mode == "haploid" else (H + 1) // 2
    y = rng.random(n).astype(np.float32)
    if keep_kind == "in_order":
        keep = np.flatnonzero(rng.random(L) < 0.7)
    elif keep_kind == "shuffled_repeats":
        keep = rng.integers(0, L, 2 * L)
        keep[:3] = [L - 1, 0, L - 1]
    else:
        keep = np.zeros(0, np.int64)
    keep = keep.astype(np.int64)
    hap = (rng.random(len(keep)) < 0.5) if mode == "mixed" else None
    return vals, keep, y, hap


@pytest.mark.parametrize("keep_kind", ["in_order", "shuffled_repeats",
                                       "empty"])
@pytest.mark.parametrize("mode", product_kernels.DOT_MODES)
@pytest.mark.parametrize("L,H", [(40, 1), (64, 301), (33, 4573),
                                 (24, 5008)])
def test_dot_rows_plain_matches_float64_and_jax(L, H, mode, keep_kind):
    vals, keep, y, hap = _case(L * H, L, H, mode, keep_kind)
    args = (torch.from_numpy(vals), torch.from_numpy(keep),
            torch.from_numpy(y), mode,
            None if hap is None else torch.from_numpy(hap))
    got = product_kernels.dot_rows(*args)
    assert got.dtype == torch.float32 and got.shape == (len(keep),)
    assert torch.equal(got, product_kernels.dot_rows_plain(*args))
    flags = np.zeros(len(keep), bool) if hap is None else hap
    want = np.array([vals[r].astype(np.float64)
                     @ _weights(y, H, mode, f) for r, f in zip(keep, flags)])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    # the JAX package's product, one weight vector per kind of line
    rows = jnp.asarray(vals[keep])
    jax_dots = np.zeros(len(keep), np.float32)
    for f in (False, True):
        w2 = jnp.asarray(_weights(y, H, mode, f).astype(np.float32))
        sel = flags == f
        if sel.any():
            jax_dots[sel] = np.asarray(rows[sel].astype(jnp.float32) @ w2)
    np.testing.assert_allclose(got.numpy(), jax_dots, rtol=RTOL, atol=0)


def test_dot_rows_mixed_haploid_lines_read_even_slots_only():
    vals = torch.tensor([[1, 1, 0, 1], [1, 1, 0, 1], [0, 1, 1, 0]],
                        dtype=torch.uint8)
    y = torch.tensor([2.0, 3.0], dtype=torch.float32)
    keep = torch.tensor([2, 0, 1, 0])
    hap = torch.tensor([True, True, False, False])
    got = product_kernels.dot_rows(vals, keep, y, "mixed", hap)
    # line 2 haploid: slot 2 (y[1]); line 0 haploid: slot 0 (y[0]);
    # lines 1, 0 diploid: slots 0, 1, 3 -> 2 + 2 + 3
    assert got.tolist() == [3.0, 2.0, 7.0, 7.0]
    assert product_kernels.dot_rows(vals, keep, y, "diploid").tolist() == \
        [5.0, 7.0, 7.0, 7.0]
    y4 = torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float32)
    assert product_kernels.dot_rows(vals, keep, y4, "haploid").tolist() == \
        [6.0, 11.0, 11.0, 11.0]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dot_rows_refusals(device):
    """Checked before the dispatch, on the CPU and on a device of neither
    route (meta); a CUDA tensor never takes the plain version."""
    other = "meta" if device == "cpu" else "cpu"
    vals = torch.zeros((4, 6), dtype=torch.uint8, device=device)
    keep = torch.tensor([0, 3, 1], dtype=torch.int64, device=device)
    y = torch.zeros(3, dtype=torch.float32, device=device)
    hap = torch.zeros(3, dtype=torch.bool, device=device)

    def elsewhere(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=other)
    cases = (
        ((vals.to(torch.int32), keep, y, "diploid"), "vals"),
        ((vals[0], keep, y, "diploid"), "vals"),
        ((torch.zeros((6, 4), dtype=torch.uint8, device=device).t(), keep,
          y, "diploid"), "vals"),
        ((vals, keep.to(torch.int32), y, "diploid"), "keep"),
        ((vals, keep[None], y, "diploid"), "keep"),
        ((vals, elsewhere(keep), y, "diploid"), "keep"),
        ((vals, keep, y, "triploid"), "mode"),
        ((vals, keep, y.to(torch.float64), "diploid"), "y must"),
        ((vals, keep, y[:2], "diploid"), "y must"),
        ((vals, keep, y, "haploid"), "y must"),       # needs 6 samples
        ((vals, keep, y[None], "diploid"), "y must"),
        ((vals, keep, elsewhere(y), "diploid"), "y must"),
        ((vals, keep, y, "mixed"), "hap"),
        ((vals, keep, y, "diploid", hap), "hap"),
        ((vals, keep, y, "mixed", hap[:2]), "hap"),
        ((vals, keep, y, "mixed", hap.to(torch.int64)), "hap"),
        ((vals, keep, y, "mixed", elsewhere(hap)), "hap"),
    )
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            product_kernels.dot_rows(*args)
    if device == "meta":
        with pytest.raises(ValueError, match="unsupported device"):
            product_kernels.dot_rows(vals, keep, y, "diploid")
        return
    for bad in ([0, 4], [-1, 2]):
        with pytest.raises(ValueError, match="outside"):
            product_kernels.dot_rows(vals, torch.tensor(bad), y, "diploid")


@pytest.mark.parametrize("H,tiles,need_dip,need_hap", [
    (1, 1, 1, 1), (1024, 1, 512, 1024), (1025, 2, 513, 1025),
    (5008, 5, 2504, 5008), (194512, 190, 97256, 194512)])
def test_dot_rows_tiles_and_samples_needed(H, tiles, need_dip, need_hap):
    assert product_kernels.tiles(H) == tiles
    assert product_kernels.samples_needed(H, "diploid") == need_dip
    assert product_kernels.samples_needed(H, "mixed") == need_dip
    assert product_kernels.samples_needed(H, "haploid") == need_hap
