"""PBWT arrangement transforms in PyTorch: the chunked encode and decode,
their forms for any width, and the mixed-ploidy scans.

Port of xsqueezeit_tpu/ops/pbwt_jax.py (pbwt_encode_chunked,
pbwt_decode_chunked, pbwt_encode_keys, pbwt_encode_scan,
pbwt_encode_scan_parity, pbwt_decode_blocked, pbwt_decode_scan_mixed;
its _rank_chain is ops/pbwt_kernels.py rank_chain).  Up to H = 65,535
lines group into chunks of C = 16; a 16-bit register per haplotype carries
the chunk's bits through the partitions, which run in the chunk-chain
kernels of ops/pbwt_kernels.py.  Cross-chunk state comes from a rank chain
(encode: the rank_chain kernels, every width) or from composing the
chunks' arrangements (decode).  Wider blocks, whose slots do not fit the
registers' 16-bit fields, encode with packed per-line keys and one batched
row sort (the scan) and decode by the blocked three-phase form;
mixed-ploidy blocks encode with the parity scan and decode with the
decode_scan_mixed kernel, one launch over all lines.

Where the JAX package applies permutations with packed row sorts (fast on a
TPU), this module scatters and gathers.  The block-start arrangement is the
identity (header iota_ppa).
"""
from __future__ import annotations

import torch

from . import pbwt_kernels

DECODE_CHUNK = 16
#: Keys per row-sort call of pbwt_encode_scan_parity (about 1 GB of int64
#: values and indices).
SORT_SLICE_ELEMS = 1 << 26


_inverse = pbwt_kernels._inverse


def _hap_bits(h: int) -> int:
    return max(int(h - 1).bit_length(), 1)


def pbwt_encode_keys(alleles: torch.Tensor, alts: torch.Tensor,
                     sorts: torch.Tensor, carry_parity: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed per-line PBWT keys (pbwt_jax.pbwt_encode_keys, a0 = iota).

    Lines group into chunks of C = 32 - b - vb (b = ceil(log2 H) rank
    bits, vb = 1, or 2 with carry_parity) so that a key (chunk-local
    history P << (b + vb)) | (chunk-start rank << vb) | [parity << 1] |
    bit fits 32 bits.  Sorting row l ascending puts the line's bits in the
    arrangement in force before line l, LSB first.  Returns (packed
    int64[L, H], r_final int64[H]).
    """
    L, H = alleles.shape
    dev = alleles.device
    b = _hap_bits(H)
    vb = 2 if carry_parity else 1
    C = 32 - b - vb
    if C < 2:
        raise ValueError(f"H={H} too large for packed PBWT encode")
    x = (alleles.to(torch.int32) == alts[:, None]).to(torch.uint8)
    sorts = sorts.to(torch.bool)
    pad = (-L) % C
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        sorts = torch.nn.functional.pad(sorts, (0, pad))
    n_ch = (L + pad) // C
    xc = x.reshape(n_ch, C, H)
    ssi = sorts.reshape(n_ch, C).to(torch.int32)
    sh = torch.cumsum(ssi, 1, dtype=torch.int32) - ssi
    # history prefix P_j of each chunk line (exclusive of line j), built
    # one line at a time so the temporaries stay [n_ch, H]; C <= 30 bits,
    # so the totals fit int32 (the rank chain kernel's input type)
    packed = torch.empty((n_ch, C, H), dtype=torch.int64, device=dev)
    T = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    for j in range(C):
        packed[:, j] = T
        T |= (xc[:, j].to(torch.int32) << sh[:, j:j + 1]) & -ssi[:, j:j + 1]

    r_fin, r_starts = pbwt_kernels.rank_chain(T, torch.arange(H, device=dev),
                                             b)
    low = r_starts << vb
    if carry_parity:
        low |= (torch.arange(H, device=dev) & 1) << 1
    for j in range(C):       # temporaries [n_ch, H], as above
        packed[:, j] = (packed[:, j] << (b + vb)) | low | xc[:, j]
    return packed.reshape(n_ch * C, H)[:L], r_fin


def _sorted_rows(packed: torch.Tensor):
    """Each row of the packed keys sorted ascending, in slices of rows of
    about SORT_SLICE_ELEMS keys (bounds the sort's memory): yields (first
    row, sorted slice)."""
    L, H = packed.shape
    step = max(1, SORT_SLICE_ELEMS // max(H, 1))
    for a in range(0, L, step):
        yield a, torch.sort(packed[a:a + step], dim=1).values


def pbwt_encode_scan(alleles: torch.Tensor, alts: torch.Tensor,
                     sorts: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Arrangement-ordered bits for every line at any width, block start
    at the identity (pbwt_jax.pbwt_encode_scan): one batched row sort of
    the packed keys puts each line's bits in the arrangement in force
    before it, in the key's lowest bit.  The form for H > 65,535, where
    the chunk chains' 16-bit slot fields do not reach.  Returns (ys
    uint8[L, H], a_final int64[H])."""
    packed, r_fin = pbwt_encode_keys(alleles, alts, sorts)
    ys = torch.empty(packed.shape, dtype=torch.uint8, device=packed.device)
    for a, s in _sorted_rows(packed):
        ys[a:a + s.shape[0]] = s & 1
    return ys, _inverse(r_fin)


def pbwt_encode_scan_parity(alleles: torch.Tensor, alts: torch.Tensor,
                            sorts: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Bits and slot parity in arrangement order for every line, block
    start at the identity (pbwt_jax.pbwt_encode_scan_parity; oracle
    pbwt_np.pbwt_encode_parity).

    The mixed-ploidy encoder needs, per line, the arrangement-ordered bit
    and the parity (a & 1) of the haplotype at each position.  One batched
    row sort of the packed keys gives both.  Returns (ys uint8[L, H], par
    uint8[L, H], a_final int64[H]).
    """
    packed, r_fin = pbwt_encode_keys(alleles, alts, sorts,
                                     carry_parity=True)
    ys = torch.empty(packed.shape, dtype=torch.uint8, device=packed.device)
    par = torch.empty_like(ys)
    for a, s in _sorted_rows(packed):
        ys[a:a + s.shape[0]] = s & 1
        par[a:a + s.shape[0]] = (s >> 1) & 1
    return ys, par, _inverse(r_fin)


def pbwt_encode_chunked(alleles: torch.Tensor, alts: torch.Tensor,
                        sorts: torch.Tensor, chunk: int = 16
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Arrangement-ordered bits for every line (H <= 65535).

    alleles: int8/int16[L, H] allele codes; alts: int32[L] target ALT per
    line; sorts: bool[L] whether the line updates the arrangement.
    Returns (ys uint8[L, H], a_final int64[H]).
    """
    L, H = alleles.shape
    if H > 65535:
        raise ValueError("pbwt_encode_chunked requires H <= 65535")
    dev = alleles.device
    C = chunk
    x = alleles == alts[:, None]
    pad = (-L) % C
    sorts = sorts.to(torch.bool)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        sorts = torch.nn.functional.pad(sorts, (0, pad))
    n_ch = (L + pad) // C
    xc = x.reshape(n_ch, C, H)

    # Registers (bit j = chunk line j) and chunk history totals over the
    # sorting lines (latest sorting bit highest), one line at a time so
    # the temporaries stay [n_ch, H] (at HRC width a [n_ch, C, H] int64
    # grid would be over 2 GB).
    ss = sorts.reshape(n_ch, C)
    ssi = ss.to(torch.int32)
    sh = torch.cumsum(ssi, 1, dtype=torch.int32) - ssi
    bhat = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    T = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    for j in range(C):
        xj = xc[:, j].to(torch.int32)
        bhat |= xj << j
        T |= (xj << sh[:, j:j + 1]) & -ssi[:, j:j + 1]

    iota = torch.arange(H, device=dev)
    r_fin, r_starts = pbwt_kernels.rank_chain(T, iota)

    # Register load: each haplotype's register lands at its chunk-start slot.
    q0 = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    q0.scatter_(1, r_starts, bhat)
    ys = pbwt_kernels.chain_encode(q0, ss)
    return ys.reshape(n_ch * C, H)[:L], _inverse(r_fin)


def _compose_prefix(o_tot: torch.Tensor) -> torch.Tensor:
    """Arrangement at the end of every chunk: inc[t] = inc[t-1][o_tot[t]]
    (inc[-1] = identity), as a log-step doubling scan of gathers."""
    inc = o_tot.clone()
    d = 1
    while d < inc.shape[0]:
        inc[d:] = torch.gather(inc[:-d], 1, inc[d:])
        d <<= 1
    return inc


def pbwt_decode_chunked(ys: torch.Tensor, sorts: torch.Tensor,
                        chunk: int = DECODE_CHUNK
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked PBWT decode (H <= 65535): bits back to natural order.

    ys: uint8[L, H] bits in arrangement order; sorts: bool[L] (all-zero
    padding rows may pass True).  Returns (vals uint8[L, H] natural-order
    bits, a_final int64[H]).
    """
    L, H = ys.shape
    if H > 65535:
        raise ValueError("pbwt_decode_chunked requires H <= 65535")
    dev = ys.device
    C = chunk
    pad = (-L) % C
    sorts = sorts.to(torch.bool)
    y = ys.to(torch.uint8)
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        sorts = torch.nn.functional.pad(sorts, (0, pad))
    n_ch = (L + pad) // C
    p_fin = pbwt_kernels.chain_decode(y.reshape(n_ch, C, H),
                                      sorts.reshape(n_ch, C))
    o_tot = p_fin >> 16                     # chunk-start slot per end slot
    beta = p_fin & 0xFFFF
    inc = _compose_prefix(o_tot)            # haplotype per end slot
    X = torch.empty_like(beta).scatter_(1, inc, beta)   # natural order
    # one line at a time: temporaries stay [n_ch, H]
    vals = torch.empty((n_ch, C, H), dtype=torch.uint8, device=dev)
    for j in range(C):
        vals[:, j] = (X >> j) & 1
    return vals.reshape(n_ch * C, H)[:L], inc[-1]


def pbwt_decode_blocked(ys: torch.Tensor, sorts: torch.Tensor,
                        chunk: int = DECODE_CHUNK
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """PBWT decode at any width (pbwt_jax.pbwt_decode_blocked): bits back
    to natural order, block start at the identity.  The form for H >
    65,535, where the chunk chains' 16-bit slot fields do not reach.

    Three phases over chunks of `chunk` lines, every step a batched
    scatter over the chunks ([n_ch, H], one chunk line at a time):
      1. per chunk, the chunk-start slot of each slot after the chunk's
         lines (the stable partitions applied to the identity);
      2. the arrangement at every chunk start, by composing those maps
         (_compose_prefix);
      3. each chunk's arrangement carried through its lines again, every
         line's bits scattered to natural order on the way.
    ys: uint8[L, H] bits in arrangement order; sorts: bool[L] (all-zero
    padding rows may pass True).  Returns (vals uint8[L, H] natural-order
    bits, a_final int64[H]).
    """
    L, H = ys.shape
    dev = ys.device
    iota = torch.arange(H, device=dev)
    if L == 0:
        return torch.zeros((0, H), dtype=torch.uint8, device=dev), iota
    C = chunk
    pad = (-L) % C
    sorts = sorts.to(torch.bool)
    y = ys.to(torch.uint8)
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        sorts = torch.nn.functional.pad(sorts, (0, pad))
    n_ch = (L + pad) // C
    yc = y.reshape(n_ch, C, H)
    ss = sorts.reshape(n_ch, C)

    def moved(j, state):
        """state carried through chunk line j's partition."""
        dest = pbwt_kernels._partition_dest(yc[:, j].to(torch.int64),
                                            ss[:, j])
        return torch.empty_like(state).scatter_(1, dest, state)

    o = iota.expand(n_ch, H).clone()        # 1. start slot per slot
    for j in range(C):
        o = moved(j, o)
    inc = _compose_prefix(o)                # 2. haplotype per end slot
    g = torch.cat([iota[None], inc[:-1]])   # haplotype per start slot
    vals = torch.empty((n_ch, C, H), dtype=torch.uint8, device=dev)
    for j in range(C):                      # 3. the lines' bits
        vals[:, j] = torch.empty((n_ch, H), dtype=torch.uint8,
                                 device=dev).scatter_(1, g, yc[:, j])
        g = moved(j, g)
    return vals.reshape(n_ch * C, H)[:L], inc[-1]


def pbwt_decode_scan_mixed(ys: torch.Tensor, sorts: torch.Tensor,
                           hap_line: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """PBWT decode of a mixed-ploidy block, block start at the identity
    (pbwt_jax.pbwt_decode_scan_mixed; pbwt_kernels.decode_scan_mixed_plain
    has the contract): the kernel on the card, one step per line on the
    CPU."""
    return pbwt_kernels.decode_scan_mixed(ys, sorts, hap_line)
